// Shared pieces of the solve kernels (K3, K1, K2, K4, K5 and the chain kernels):
// the explicit RK tableau (any embedded pair up to kMaxStages stages), the PI
// step-size controller, the fixed-order block and grid reductions that give
// every block bitwise the same error norm, the cooperative-launch helpers,
// the 2-layer weights' shared-memory layout with its float4 row products,
// the whole adaptive forward solve of a per-sample field (K3, K1, the K4
// forward, the K1 chain form and K7) and the whole adaptive backsolve of a
// per-sample augmented stage with a batch-summed gradient (K2, the K4
// adjoint, the K2 chain form and K5), and both solves' block-cooperative forms,
// which evaluate a stage for a tile of samples at once (the wide chain
// kernels; the section at the end).
//
// The forward solve keeps the state [z (dz rows) | accumulators (NACC rows)]
// in a global scratch laid out (row, B), so a warp's accesses are coalesced.
// One thread owns one sample at a time (threads stride over samples beyond
// the co-resident grid); the controller state is held, and updated
// identically, by every thread.  One grid.sync() per attempted step: each
// block writes its partial error sums and finite flag into a buffer chosen
// by step parity, and after the barrier every block sums all partials in the
// same order.  A block can only overwrite a parity's buffer after the next
// step's barrier, which every block reaches only once it has read it.
//
// The tableau is a run-time value, copied once into the block's shared
// memory (the loop over the stages is not unrolled, so one kernel instance
// runs every tableau and its field is inlined once; the loops over stored
// stages are unrolled by a per-kernel factor): S stages, FSAL or not (a non-FSAL
// tableau re-evaluates stage 1 at the new point after an accepted step; a
// rejected step keeps the point, so the old stage is kept), and for dop853
// a second error sum with btilde3 beside the first, combined into Hairer's
// stretched estimate eest = e5^2 / sqrt(e5^2 + 0.01 e3^2) of the two
// batch-global norms (ode/solve.py::_attempt_step).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cnf {

namespace cg = cooperative_groups;

constexpr int kMaxStages = 13;  // dop853; tsit5 and dopri5 have 7, verner65 8, bosh3 4
constexpr int kMaxBlock = 256;
constexpr int kRedFloats = 3 * 32 + 4;  // per-warp sums (two) and flags, three broadcasts, padded to 16 bytes
constexpr int kTableauFloats = kMaxStages * kMaxStages + 3 * kMaxStages + 3;

struct Tableau {
  float a[kMaxStages][kMaxStages];  // a[i][j] for j < i < S
  float b[kMaxStages];
  float btilde[kMaxStages];
  float btilde3[kMaxStages];  // zero unless has3
  int S;                      // stages
  int fsal;                   // stage S is f at the proposed point
  int has3;                   // dop853's stretched 5(3) estimate
};

// tab: a (kMaxStages x kMaxStages, row-major) | b | btilde | btilde3 | S |
// fsal | has3 (kTableauFloats floats), as the wrappers pass it.
inline void read_tableau(const float* tab, Tableau* t) {
  constexpr int M = kMaxStages, o = M * M;
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j < M; ++j) t->a[i][j] = tab[i * M + j];
    t->b[i] = tab[o + i];
    t->btilde[i] = tab[o + M + i];
    t->btilde3[i] = tab[o + 2 * M + i];
  }
  t->S = (int)tab[o + 3 * M];
  t->fsal = (int)tab[o + 3 * M + 1];
  t->has3 = (int)tab[o + 3 * M + 2];
}

// The tableau a solve reads, copied once into the block's shared memory
// (the stage loops index it with run-time indices).
__device__ inline const Tableau& share_tableau(const Tableau& from) {
  __shared__ Tableau t;
  if (threadIdx.x == 0) t = from;
  __syncthreads();
  return t;
}

// Hairer's stretched 8(5,3) estimate from the two norms (dop853.f), as
// ode/solve.py::_attempt_step combines them.
__device__ __forceinline__ float stretched_eest(float e5, float e3) {
  const float denom = sqrtf(e5 * e5 + 0.01f * (e3 * e3));
  return denom > 0.f ? (e5 * e5) / fmaxf(denom, 1e-30f) : e5;
}

__device__ __forceinline__ float safe_norm_sq(float sq) { return sq > 0.f ? sqrtf(sq) : 0.f; }

// Cotangent factor of a safe norm: ct / ||v||, 0 at v = 0.
__device__ __forceinline__ float ct_safe_norm(float ct, float norm) { return norm > 0.f ? ct / norm : 0.f; }

// <v, w> for a DZ-vector v in registers and a 16-byte aligned row w of
// shared memory, read as float4 broadcasts, in four partial sums.
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

// acc += c * w for a 16-byte aligned row w of shared memory.
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

// The 2-layer net's weights as the kernels keep them in shared memory, the
// state width padded to DZ with zero columns: w1t[j][i] = w1[i][j] and
// w2p[j][k] = w2[j][k], both (H, DZ); b2p (DZ).  Returns the float count.
template <int DZ>
__host__ __device__ inline size_t weight_floats(int H) { return 2 * (size_t)H * DZ + DZ + H; }

template <int DZ>
__device__ void load_weights(const float* w1, const float* b1, const float* w2, const float* b2,
                             int dz, int H, float* w1t, float* w2p, float* b2p, float* b1s) {
  for (int idx = threadIdx.x; idx < H * DZ; idx += blockDim.x) {
    const int j = idx / DZ, i = idx % DZ;
    w1t[idx] = i < dz ? w1[(size_t)i * H + j] : 0.f;
    w2p[idx] = i < dz ? w2[(size_t)j * dz + i] : 0.f;
  }
  for (int k = threadIdx.x; k < DZ; k += blockDim.x) b2p[k] = k < dz ? b2[k] : 0.f;
  for (int j = threadIdx.x; j < H; j += blockDim.x) b1s[j] = b1[j];
}

// The padded state width a kernel is compiled for (4, 8, 16 or 32), 0 if none.
inline int padded_dz(int dz) {
  if (dz < 1) return 0;
  if (dz <= 4) return 4;
  if (dz <= 8) return 8;
  if (dz <= 16) return 16;
  if (dz <= 32) return 32;
  return 0;
}

// The adaptive-step state of ode/solve.py::_attempt_step.
struct Controller {
  float t, t1, tdir, dt, eest_prev;
  int steps, accepted;
  float beta1, beta2, inv_order;

  __device__ void init(const float* ts, float b1, float b2, float io) {
    t = ts[0];
    t1 = ts[1];
    dt = ts[2];
    tdir = t1 > t ? 1.f : (t1 < t ? -1.f : 0.f);
    eest_prev = 1.f;
    steps = 0;
    accepted = 0;
    beta1 = b1;
    beta2 = b2;
    inv_order = io;
  }

  __device__ bool running(int max_steps) const {
    return (t - t1) * tdir < 0.f && steps < max_steps;
  }

  // The step to attempt; is_last when it reaches t1.
  __device__ float plan(bool* is_last) const {
    const float remaining = fabsf(t1 - t);
    *is_last = fabsf(dt) >= remaining;
    return tdir * fminf(fabsf(dt), remaining);
  }

  // Accept or reject the attempted step and set the next step size (the PI
  // controller of fused_solve.py::_controller_update).  Returns accept.
  __device__ bool update(float eest, bool all_finite, float dt_use, bool is_last) {
    const bool fin = all_finite && isfinite(eest);
    const bool accept = eest <= 1.f && fin;
    const float eest_c = fmaxf(eest, 1e-4f);
    float q_acc = 0.9f * powf(eest_c, -beta1) * powf(eest_prev, beta2);
    if (!isfinite(q_acc)) q_acc = 0.2f;
    float q_rej = 0.9f * powf(eest_c, -inv_order);
    if (!isfinite(q_rej) || !fin) q_rej = 0.2f;
    dt = accept ? dt_use * fminf(fmaxf(q_acc, 0.2f), 10.f)
                : dt_use * fminf(fmaxf(q_rej, 0.2f), 1.f);
    if (accept) {
      t = is_last ? t1 : t + dt_use;
      eest_prev = eest_c;
      ++accepted;
    }
    ++steps;
    return accept;
  }
};

// Sum of v over the block in a fixed order (warp shuffles, then the warps in
// order); the result is returned to every thread.  red: kRedFloats floats.
__device__ inline float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[w];
    red[96] = s;
  }
  __syncthreads();
  return red[96];
}

// Write this block's partial error sums (the btilde one, and the btilde3 one
// when has3) and finite flag (1 or 0) into the parity's slots of `partials`
// ([parity][sum | sum3 | flag][gridDim.x]).
__device__ inline void write_block_partial(float sumsq, float sumsq3, bool has3, bool finite, float* partials,
                                           int par, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  float v = sumsq, v3 = sumsq3;
  float fl = finite ? 1.f : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
    fl = fminf(fl, __shfl_down_sync(0xffffffffu, fl, off));
  }
  if (has3) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v3 += __shfl_down_sync(0xffffffffu, v3, off);
  }
  if (lane == 0) {
    red[warp] = v;
    red[32 + warp] = fl;
    red[64 + warp] = v3;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bsum = 0.f, bsum3 = 0.f, bflag = 1.f;
    for (int w = 0; w < nwarps; ++w) {
      bsum += red[w];
      bflag = fminf(bflag, red[32 + w]);
    }
    if (has3)
      for (int w = 0; w < nwarps; ++w) bsum3 += red[64 + w];
    float* psum = partials + (size_t)(3 * par) * gridDim.x;
    psum[blockIdx.x] = bsum;
    psum[gridDim.x + blockIdx.x] = bsum3;
    psum[2 * gridDim.x + blockIdx.x] = bflag;
  }
}

// After the grid barrier: the sums of all blocks' partials (total3 stays 0
// unless has3) and whether all were finite, summed in block order by every
// block (so bitwise equal).
__device__ inline void read_grid_total(const float* partials, int par, bool has3, float* red, float* total,
                                       float* total3, bool* all_finite) {
  const float* psum = partials + (size_t)(3 * par) * gridDim.x;
  if (threadIdx.x == 0) {
    float tot = 0.f, tot3 = 0.f, all = 1.f;
    for (int g = 0; g < (int)gridDim.x; ++g) {
      tot += __ldcg(psum + g);
      all = fminf(all, __ldcg(psum + 2 * gridDim.x + g));
    }
    if (has3)
      for (int g = 0; g < (int)gridDim.x; ++g) tot3 += __ldcg(psum + gridDim.x + g);
    red[96] = tot;
    red[97] = tot3;
    red[98] = all;
  }
  __syncthreads();
  *total = red[96];
  *total3 = red[97];
  *all_finite = red[98] > 0.5f;
  __syncthreads();
}

// Arguments of the forward solve kernels (K3: NACC = 1, K1: NACC = 3).
struct FwdArgs {
  const float* w1;    // (dz, H), layer 1 computes z @ w1 + b1
  const float* b1;    // (H)
  const float* w2;    // (H, dz)
  const float* b2;    // (dz)
  const float* eps;   // (B, dz) Hutchinson probe (K1), unused by K3 and K4
  const float* z0;    // (B, dz)
  const float* acc0;  // (NACC, B) accumulators the solve starts from
  const float* ts;    // t0, t1, dt_init
  float* zT;          // (B, dz)
  float* accT;        // (NACC, B)
  int* stats;         // attempted, accepted
  float* dt_last;     // (2): the next step size, and the last step taken
  float* work;        // (S + 2) * (dz + NACC) * B
  float* partials;    // [parity][sum | sum3 | flag][gridDim.x]
  int B, dz, H, max_steps, norm_z, norm_j;
  float rtol, atol, beta1, beta2, inv_order;
  Tableau tab;
};

// The whole adaptive solve of [z | acc] from ts[0] to ts[1] under the
// tableau the arguments carry.  `field(s, z, ky, kr)` evaluates sample s's
// field at z: ky (DZ) and the accumulator rates kr (NACC); z is zero beyond
// dz and ky must be too.  red: kRedFloats floats of shared memory.  The
// loops over the stages run at run time: the field is inlined once per
// call site, and one instance runs every tableau.  U: the unroll factor of
// the loops over stored stages (the stage combination and the error sums),
// chosen per kernel from CUDA-event times on the H100 (PERF.md).
template <int DZ, int NACC, int U, class Field>
__device__ void forward_solve(const FwdArgs& p, const Field& field, float* red) {
  cg::grid_group grid = cg::this_grid();
  const Tableau& T = share_tableau(p.tab);
  const int S = T.S;
  const bool has3 = T.has3 != 0;
  const bool fsal = T.fsal != 0;
  const int dz = p.dz, B = p.B, R = dz + NACC;
  const int nthr = gridDim.x * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t RB = (size_t)R * B;  // one (row, B) plane
  float* Y = p.work;                // current state: z rows, then the accumulator rows
  float* Yn = Y + RB;               // proposed state
  float* K = Yn + RB;               // stage registers, S planes

  // Sample s's field at the current state Y into the stage plane K[0].
  auto stage1 = [&](int s) {
    float z[DZ], ky[DZ], kr[NACC];
#pragma unroll
    for (int i = 0; i < DZ; ++i) z[i] = i < dz ? Y[(size_t)i * B + s] : 0.f;
    field(s, z, ky, kr);
#pragma unroll
    for (int i = 0; i < DZ; ++i)
      if (i < dz) K[(size_t)i * B + s] = ky[i];
#pragma unroll
    for (int r = 0; r < NACC; ++r) K[(size_t)(dz + r) * B + s] = kr[r];
  };
  // Stage st of sample s: the field at Y + dt sum_j a[st][j] K[j].
  auto stage = [&](int s, int st, float dt_use) {
    float z[DZ], ky[DZ], kr[NACC];
#pragma unroll
    for (int i = 0; i < DZ; ++i) z[i] = i < dz ? Y[(size_t)i * B + s] : 0.f;
#pragma unroll (U)
    for (int j = 0; j < st; ++j) {
      const float a = T.a[st][j];
      if (a != 0.f) {
        const float cf = dt_use * a;
        const float* kj = K + j * RB;
#pragma unroll
        for (int i = 0; i < DZ; ++i)
          if (i < dz) z[i] = fmaf(cf, kj[(size_t)i * B + s], z[i]);
      }
    }
    field(s, z, ky, kr);
    float* kst = K + st * RB;
#pragma unroll
    for (int i = 0; i < DZ; ++i)
      if (i < dz) kst[(size_t)i * B + s] = ky[i];
#pragma unroll
    for (int r = 0; r < NACC; ++r) kst[(size_t)(dz + r) * B + s] = kr[r];
  };

  // Initial state (accumulators seeded from acc0) and the first stage.
  for (int s = gtid; s < B; s += nthr) {
    for (int i = 0; i < dz; ++i) Y[(size_t)i * B + s] = p.z0[(size_t)s * dz + i];
    for (int r = 0; r < NACC; ++r) Y[(size_t)(dz + r) * B + s] = p.acc0[(size_t)r * B + s];
    stage1(s);
  }

  Controller c;
  c.init(p.ts, p.beta1, p.beta2, p.inv_order);
  const float n_elems = (float)RB;
  float dt_taken = 0.f;

  while (c.running(p.max_steps)) {
    bool is_last;
    const float dt_use = c.plan(&is_last);
    dt_taken = dt_use;

    float sumsq = 0.f, sumsq3 = 0.f;
    bool finite = true;
    for (int s = gtid; s < B; s += nthr) {
#pragma unroll 1
      for (int st = 1; st < S; ++st) stage(s, st, dt_use);
      for (int r = 0; r < R; ++r) {
        const size_t o = (size_t)r * B + s;
        const float y = Y[o];
        float yn = y, err = 0.f, err3 = 0.f;
#pragma unroll (U)
        for (int st = 0; st < S; ++st) {
          const float k = K[st * RB + o];
          if (T.b[st] != 0.f) yn = fmaf(dt_use * T.b[st], k, yn);
          if (T.btilde[st] != 0.f) err = fmaf(dt_use * T.btilde[st], k, err);
          if (has3 && T.btilde3[st] != 0.f) err3 = fmaf(dt_use * T.btilde3[st], k, err3);
        }
        Yn[o] = yn;
        const float sc = p.atol + p.rtol * fmaxf(fabsf(y), fabsf(yn));
        const float q = err / sc;
        sumsq = fmaf(q, q, sumsq);
        if (has3) {
          const float q3 = err3 / sc;
          sumsq3 = fmaf(q3, q3, sumsq3);
        }
        finite = finite && isfinite(yn);
      }
    }

    const int par = c.steps & 1;
    write_block_partial(sumsq, sumsq3, has3, finite, p.partials, par, red);
    grid.sync();
    float total, total3;
    bool all_finite;
    read_grid_total(p.partials, par, has3, red, &total, &total3, &all_finite);
    float eest = sqrtf(total / n_elems);
    if (has3) eest = stretched_eest(eest, sqrtf(total3 / n_elems));
    if (c.update(eest, all_finite, dt_use, is_last)) {
      // Accept: the proposed state becomes current, and with it stage 1: FSAL
      // the last stage, else the field re-evaluated at the new point.
      for (int s = gtid; s < B; s += nthr) {
        for (int r = 0; r < R; ++r) {
          const size_t o = (size_t)r * B + s;
          Y[o] = Yn[o];
          if (fsal) K[o] = K[(S - 1) * RB + o];
        }
        if (!fsal) stage1(s);
      }
    }
  }

  for (int s = gtid; s < B; s += nthr) {
    for (int i = 0; i < dz; ++i) p.zT[(size_t)s * dz + i] = Y[(size_t)i * B + s];
    for (int r = 0; r < NACC; ++r) p.accT[(size_t)r * B + s] = Y[(size_t)(dz + r) * B + s];
  }
  if (gtid == 0) {
    p.stats[0] = c.steps;
    p.stats[1] = c.accepted;
    p.dt_last[0] = c.dt;
    p.dt_last[1] = dt_taken;
  }
}

// Arguments of the adjoint solve kernels (K2, the K4 adjoint, K5) besides
// the net and its gradient outputs.  NACC: the accumulator rows, 3 in TRAIN
// mode (dlogp, reg_e, reg_n) and 1 in TEST mode (dlogp, K5).
struct AdjState {
  const float* zT;    // (B, dz) state at t_hi
  const float* accT;  // (NACC, B)
  const float* azT;   // (B, dz) cotangent of z at t_hi
  const float* aaccT; // (NACC, B) cotangent of acc (constant)
  const float* ts;    // t_hi, t_lo, dt_init
  float* z0;          // (B, dz) state at t_lo
  float* acc0;        // (NACC, B)
  float* az0;         // (B, dz)
  float* ays0;        // (B, nc) cotangent of the conditioning at t_lo (nc > 0)
  int* stats;         // attempted, accepted
  float* work;        // (S + 2) * (2 dz + NACC + nc) * B
  float* partials;    // [parity][sum | sum3 | flag][gridDim.x]
  float* gpart;       // [parity][gridDim.x][NG Pg]: the blocks' b-, btilde- (and btilde3-) weighted g sums
  int B, dz, nc, max_steps;  // nc: per-sample conditioning cotangent rows (0 but for the COND instances)
  float rtol, atol, beta1, beta2, inv_order;
  Tableau tab;
};

// The whole adaptive backsolve (K2, the K4 adjoint, the K2 chain form and,
// with NACC = 1, K5) of the per-sample state (z, acc, a_z, a_acc: NACC rows
// each, a_acc constant; a_ys for a conditional net) and of the batch-summed
// gradient g (Pg floats) from
// ts[0] to ts[1].  Per sample, `stage(s, z, az, aacc, kz, kr, kaz, kys)`
// evaluates the augmented stage (the field, its rates, k_az = -ct_z and, in
// a COND instance, k_ays = -ct_ys written to kys[c * B], c < p.nc; kys is
// null otherwise) and leaves in the thread's slot what `grad` reads; after each stage `grad(q, base, nvalid)`
// is the block's sum, over its samples base .. base + nvalid - 1 in thread
// order, of the negated g rate entry q.  a_ys starts at 0; its rate does not
// read it (a quadrature, like g), so its nc rows ride in the (row, B) planes
// after a_z but are never staged back into the field's input.  A non-COND
// instance (K2, the K4 adjoint, unconditional nets) compiles without them.
//
// One batch-global Hairer norm over B * (2 * (dz + NACC) + nc) + Pg elements,
// the g entries scaled by atol + rtol * max(|g|, |g_new|) of the batch-summed
// values.  Each block accumulates its partials of dt * sum_i b_i k_g,i and
// dt * sum_i btilde_i k_g,i (and, for dop853, dt * sum_i btilde3_i k_g,i:
// NG = 3 vectors, else 2) in its parity-indexed slice of gpart, writes its
// per-sample sums of squares, one grid.sync(), and then every block adds all
// blocks' vectors in block order, so every block holds the same g and takes
// the same decision.  Stage 1 keeps each block's own partial of its g rate
// (the sum is linear in the samples): FSAL the last stage's, a non-FSAL
// tableau the refresh's at the accepted point.  gp, gnew, K1p and K7p are the
// block's own Pg-float buffers (shared or global memory) for g, the proposed
// g, and the stage-1 and last-stage partials; on return gp holds g.
// U: as forward_solve's.
//
// PROBES (K6: the Hutchinson kernels' probe instances, K probes a sample):
// one slot holds one probe's residuals, so a stage runs in sub-passes.  Every
// thread of the block calls `stage.probes(valid, s, z, az, aacc, kz, kr, kaz,
// kys, flush)` (threads past B with `valid` false compute nothing), which
// calls `flush()` after each probe has left its residuals in the slot; a
// flush adds the block's probe terms `grad.probe(q, base, nvalid)` of every
// entry q, and after the stage the forward chain's `grad.fwd(q, base,
// nvalid)`: the sub-passes sum to the stage's g rate (in another order).
template <int DZ, bool COND, int U, bool PROBES = false, int NACC = 3, class Stage, class Grad>
__device__ void adjoint_solve(const AdjState& p, const Stage& stage, const Grad& grad, int Pg, float* gp,
                              float* gnew, float* K1p, float* K7p, float* red) {
  cg::grid_group grid = cg::this_grid();
  const Tableau& T = share_tableau(p.tab);
  const int S = T.S;
  const bool has3 = T.has3 != 0;
  const bool fsal = T.fsal != 0;
  const int NG = has3 ? 3 : 2;
  const int dz = p.dz, B = p.B, G = gridDim.x;
  const int nc = COND ? p.nc : 0;
  const int nthr = G * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int rounds = (B + nthr - 1) / nthr;
  const int R = 2 * dz + NACC + nc;  // rows: z, acc, a_z, a_ys
  const size_t RB = (size_t)R * B;  // one (row, B) plane
  float* Y = p.work;
  float* Yn = Y + RB;
  float* K = Yn + RB;

  // Sample s's stage at (z, az), its rates stored into the plane kst.
  auto run_stage = [&](int s, const float (&z)[DZ], const float (&az)[DZ], auto* kst) {
    float aacc[NACC], kz[DZ], kr[NACC], kaz[DZ];
#pragma unroll
    for (int r = 0; r < NACC; ++r) aacc[r] = p.aaccT[(size_t)r * B + s];
    stage(s, z, az, aacc, kz, kr, kaz, COND ? kst + (size_t)(2 * dz + NACC) * B + s : nullptr);
#pragma unroll
    for (int i = 0; i < DZ; ++i) {
      if (i < dz) {
        kst[(size_t)i * B + s] = kz[i];
        kst[(size_t)(dz + NACC + i) * B + s] = kaz[i];
      }
    }
#pragma unroll
    for (int r = 0; r < NACC; ++r) kst[(size_t)(dz + r) * B + s] = kr[r];
  };
  // The block's samples in round rd: [base, base + nvalid).
  auto round_base = [&](int rd) { return rd * nthr + (int)(blockIdx.x * blockDim.x); };
  auto round_valid = [&](int rd) { return max(0, min((int)blockDim.x, B - round_base(rd))); };
  // PROBES: round rd of stage st (0: stage 1 at Y) in its sub-passes, each
  // block entry q of the g rate handed to consume(q, g) once a sub-pass.
  auto probe_round = [&](const auto& stg, const auto& grd, int rd, int st, float dt_use, const auto& consume) {
    const int s = gtid + rd * nthr;
    const bool valid = s < B;
    const int base = round_base(rd), nv = round_valid(rd);
    float z[DZ], az[DZ], aacc[NACC] = {}, kz[DZ], kr[NACC], kaz[DZ];
#pragma unroll
    for (int i = 0; i < DZ; ++i) {
      z[i] = valid && i < dz ? Y[(size_t)i * B + s] : 0.f;
      az[i] = valid && i < dz ? Y[(size_t)(dz + NACC + i) * B + s] : 0.f;
    }
    if (valid) {
      for (int j = 0; j < st; ++j) {
        const float a = T.a[st][j];
        if (a != 0.f) {
          const float cf = dt_use * a;
          const float* kj = K + j * RB;
#pragma unroll
          for (int i = 0; i < DZ; ++i) {
            if (i < dz) {
              z[i] = fmaf(cf, kj[(size_t)i * B + s], z[i]);
              az[i] = fmaf(cf, kj[(size_t)(dz + NACC + i) * B + s], az[i]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < NACC; ++r) aacc[r] = p.aaccT[(size_t)r * B + s];
    }
    float* kst = K + st * RB;
    auto flush = [&]() {
      __syncthreads();
      for (int q = threadIdx.x; q < Pg; q += blockDim.x) consume(q, grd.probe(q, base, nv));
      __syncthreads();
    };
    stg.probes(valid, s, z, az, aacc, kz, kr, kaz, COND && valid ? kst + (size_t)(2 * dz + NACC) * B + s : nullptr,
               flush);
    if (valid) {
#pragma unroll
      for (int i = 0; i < DZ; ++i) {
        if (i < dz) {
          kst[(size_t)i * B + s] = kz[i];
          kst[(size_t)(dz + NACC + i) * B + s] = kaz[i];
        }
      }
#pragma unroll
      for (int r = 0; r < NACC; ++r) kst[(size_t)(dz + r) * B + s] = kr[r];
    }
    __syncthreads();
    for (int q = threadIdx.x; q < Pg; q += blockDim.x) consume(q, grd.fwd(q, base, nv));
    __syncthreads();
  };
  // Stage 1 at the current state Y into the plane K[0], its g rate partial
  // into K1p (the initial stage, and a non-FSAL tableau's refresh).
  auto stage1 = [&]() {
    for (int q = threadIdx.x; q < Pg; q += blockDim.x) K1p[q] = 0.f;
    __syncthreads();
    for (int rd = 0; rd < rounds; ++rd) {
      if constexpr (PROBES) {
        probe_round(stage, grad, rd, 0, 0.f, [&](int q, float g) { K1p[q] += g; });
      } else {
        const int s = gtid + rd * nthr;
        if (s < B) {
          float z[DZ], az[DZ];
#pragma unroll
          for (int i = 0; i < DZ; ++i) {
            z[i] = i < dz ? Y[(size_t)i * B + s] : 0.f;
            az[i] = i < dz ? Y[(size_t)(dz + NACC + i) * B + s] : 0.f;
          }
          run_stage(s, z, az, K);
        }
        __syncthreads();
        const int base = round_base(rd), nv = round_valid(rd);
        for (int q = threadIdx.x; q < Pg; q += blockDim.x) K1p[q] += grad(q, base, nv);
        __syncthreads();
      }
    }
  };

  // Initial state.
  for (int s = gtid; s < B; s += nthr) {
    for (int i = 0; i < dz; ++i) {
      Y[(size_t)i * B + s] = p.zT[(size_t)s * dz + i];
      Y[(size_t)(dz + NACC + i) * B + s] = p.azT[(size_t)s * dz + i];
    }
    for (int r = 0; r < NACC; ++r) Y[(size_t)(dz + r) * B + s] = p.accT[(size_t)r * B + s];
    for (int c = 0; c < nc; ++c) Y[(size_t)(2 * dz + NACC + c) * B + s] = 0.f;
  }
  for (int q = threadIdx.x; q < Pg; q += blockDim.x) gp[q] = 0.f;
  stage1();

  Controller c;
  c.init(p.ts, p.beta1, p.beta2, p.inv_order);
  const float n_elems = (float)B * (float)(2 * (dz + NACC) + nc) + (float)Pg;

  while (c.running(p.max_steps)) {
    bool is_last;
    const float dt_use = c.plan(&is_last);
    const int par = c.steps & 1;
    float* GB = p.gpart + ((size_t)par * G + blockIdx.x) * NG * Pg;
    float* GE = GB + Pg;
    float* GE3 = GE + Pg;
    const float cb0 = dt_use * T.b[0], ce0 = dt_use * T.btilde[0], ce30 = dt_use * T.btilde3[0];
    for (int q = threadIdx.x; q < Pg; q += blockDim.x) {
      GB[q] = cb0 * K1p[q];
      GE[q] = ce0 * K1p[q];
      if (has3) GE3[q] = ce30 * K1p[q];
      K7p[q] = 0.f;
    }

    // Stage st over the block's rounds, and its g rate partials.
    auto stage_st = [&](int st) {
      for (int rd = 0; rd < rounds; ++rd) {
        if constexpr (PROBES) {
          const float cb = dt_use * T.b[st], ce = dt_use * T.btilde[st], ce3 = dt_use * T.btilde3[st];
          const bool last = fsal && st == S - 1;
          probe_round(stage, grad, rd, st, dt_use, [&](int q, float g) {
            if (T.b[st] != 0.f) GB[q] = fmaf(cb, g, GB[q]);
            if (T.btilde[st] != 0.f) GE[q] = fmaf(ce, g, GE[q]);
            if (has3 && T.btilde3[st] != 0.f) GE3[q] = fmaf(ce3, g, GE3[q]);
            if (last) K7p[q] += g;
          });
        } else {
          const int s = gtid + rd * nthr;
          if (s < B) {
            float z[DZ], az[DZ];
#pragma unroll
            for (int i = 0; i < DZ; ++i) {
              z[i] = i < dz ? Y[(size_t)i * B + s] : 0.f;
              az[i] = i < dz ? Y[(size_t)(dz + NACC + i) * B + s] : 0.f;
            }
#pragma unroll (U)
            for (int j = 0; j < st; ++j) {
              const float a = T.a[st][j];
              if (a != 0.f) {
                const float cf = dt_use * a;
                const float* kj = K + j * RB;
#pragma unroll
                for (int i = 0; i < DZ; ++i) {
                  if (i < dz) {
                    z[i] = fmaf(cf, kj[(size_t)i * B + s], z[i]);
                    az[i] = fmaf(cf, kj[(size_t)(dz + NACC + i) * B + s], az[i]);
                  }
                }
              }
            }
            run_stage(s, z, az, K + st * RB);
          }
          __syncthreads();
          const float bs = T.b[st], bt = T.btilde[st], bt3 = T.btilde3[st];
          const float cb = dt_use * bs, ce = dt_use * bt, ce3 = dt_use * bt3;
          const bool last = fsal && st == S - 1;
          const int base = round_base(rd), nv = round_valid(rd);
          for (int q = threadIdx.x; q < Pg; q += blockDim.x) {
            const float g = grad(q, base, nv);
            if (bs != 0.f) GB[q] = fmaf(cb, g, GB[q]);
            if (bt != 0.f) GE[q] = fmaf(ce, g, GE[q]);
            if (has3 && bt3 != 0.f) GE3[q] = fmaf(ce3, g, GE3[q]);
            if (last) K7p[q] += g;
          }
          __syncthreads();
        }
      }
    };
#pragma unroll 1
    for (int st = 1; st < S; ++st) stage_st(st);

    // Per-sample proposals and errors: z, acc, a_z and a_ys rows (a_acc is
    // constant: zero error, but counted in n_elems).
    float sumsq = 0.f, sumsq3 = 0.f;
    bool finite = true;
    for (int s = gtid; s < B; s += nthr) {
      for (int r = 0; r < R; ++r) {
        const size_t off = (size_t)r * B + s;
        const float y = Y[off];
        float yn = y, err = 0.f, err3 = 0.f;
#pragma unroll (U)
        for (int st = 0; st < S; ++st) {
          const float k = K[st * RB + off];
          if (T.b[st] != 0.f) yn = fmaf(dt_use * T.b[st], k, yn);
          if (T.btilde[st] != 0.f) err = fmaf(dt_use * T.btilde[st], k, err);
          if (has3 && T.btilde3[st] != 0.f) err3 = fmaf(dt_use * T.btilde3[st], k, err3);
        }
        Yn[off] = yn;
        const float sc = p.atol + p.rtol * fmaxf(fabsf(y), fabsf(yn));
        const float qv = err / sc;
        sumsq = fmaf(qv, qv, sumsq);
        if (has3) {
          const float q3 = err3 / sc;
          sumsq3 = fmaf(q3, q3, sumsq3);
        }
        if (r < dz || r >= dz + NACC) finite = finite && isfinite(yn);
      }
    }

    write_block_partial(sumsq, sumsq3, has3, finite, p.partials, par, red);
    grid.sync();
    float total, total3;
    bool all_finite;
    read_grid_total(p.partials, par, has3, red, &total, &total3, &all_finite);
    // The g block: all blocks' vectors summed in block order (the btilde3
    // one in a pass of its own, so the common pass stays as tight).
    const size_t gstride = (size_t)NG * Pg;
    float gsq = 0.f;
    for (int q = threadIdx.x; q < Pg; q += blockDim.x) {
      float gs = 0.f, es = 0.f;
      for (int g = 0; g < G; ++g) {
        const float* base = p.gpart + ((size_t)par * G + g) * gstride;
        gs += __ldcg(base + q);
        es += __ldcg(base + Pg + q);
      }
      const float gn = gp[q] + gs;
      gnew[q] = gn;
      const float qv = es / (p.atol + p.rtol * fmaxf(fabsf(gp[q]), fabsf(gn)));
      gsq = fmaf(qv, qv, gsq);
    }
    gsq = block_sum(gsq, red);
    float eest = sqrtf((total + gsq) / n_elems);
    if (has3) {
      float gsq3 = 0.f;
      for (int q = threadIdx.x; q < Pg; q += blockDim.x) {
        float es3 = 0.f;
        for (int g = 0; g < G; ++g) es3 += __ldcg(p.gpart + ((size_t)par * G + g) * gstride + 2 * Pg + q);
        const float q3 = es3 / (p.atol + p.rtol * fmaxf(fabsf(gp[q]), fabsf(gnew[q])));
        gsq3 = fmaf(q3, q3, gsq3);
      }
      eest = stretched_eest(eest, sqrtf((total3 + block_sum(gsq3, red)) / n_elems));
    }
    if (c.update(eest, all_finite, dt_use, is_last)) {
      for (int s = gtid; s < B; s += nthr) {
        for (int r = 0; r < R; ++r) {
          const size_t off = (size_t)r * B + s;
          Y[off] = Yn[off];
          if (fsal) K[off] = K[(S - 1) * RB + off];
        }
      }
      for (int q = threadIdx.x; q < Pg; q += blockDim.x) {
        gp[q] = gnew[q];
        if (fsal) K1p[q] = K7p[q];
      }
      if (!fsal) {
        __syncthreads();
        stage1();
      }
    }
    __syncthreads();
  }

  for (int s = gtid; s < B; s += nthr) {
    for (int i = 0; i < dz; ++i) {
      p.z0[(size_t)s * dz + i] = Y[(size_t)i * B + s];
      p.az0[(size_t)s * dz + i] = Y[(size_t)(dz + NACC + i) * B + s];
    }
    for (int r = 0; r < NACC; ++r) p.acc0[(size_t)r * B + s] = Y[(size_t)(dz + r) * B + s];
    for (int c = 0; c < nc; ++c) p.ays0[(size_t)s * nc + c] = Y[(size_t)(2 * dz + NACC + c) * B + s];
  }
  if (gtid == 0) {
    p.stats[0] = c.steps;
    p.stats[1] = c.accepted;
  }
}

// ---- the block-cooperative solves (the wide chain kernels) ----
//
// The same solves, with a block evaluating each stage for a tile of T
// samples at once (tile k: samples kT .. kT + T - 1, the last one ragged;
// block b takes tiles b, b + gridDim.x, ...), so the field's vectors live in
// the block's shared memory and not in one thread's registers.  The
// controller, the tableau in shared memory, the parity-indexed partials,
// the one batch-global Hairer norm and the fixed-order grid sums are
// forward_solve's and adjoint_solve's; the state, proposal and stage planes
// stay in the (row, B) global layout.  A tile's stage input and output move
// between the planes and the tile's (T, tile_pitch(dz)) shared arrays, T rows a
// column (coalesced in runs of T).  Rows t >= nv of a ragged tile hold
// zeros as input; their outputs are not stored.

// The row pitch of a tile's (T, width) arrays: width rounded up to 4, so
// every row starts 16-byte aligned for float4 reads.
__host__ __device__ inline int tile_pitch(int width) { return (width + 3) / 4 * 4; }

// dst[t * zp + i] = Y[row0 + i][s] + sum_(j < st) dt a[st][j] K_j[row0 + i][s]
// for i < nrows, s = s0 + t, t < nv; 0 for nv <= t < T.
template <int U>
__device__ void tile_stage_input(const Tableau& Tb, int st, float dt_use, const float* Y, const float* K, size_t RB,
                                 int B, int row0, int nrows, int s0, int nv, int T, float* dst, int zp) {
  for (int idx = threadIdx.x; idx < nrows * T; idx += blockDim.x) {
    const int i = idx / T, t = idx % T;
    float v = 0.f;
    if (t < nv) {
      const size_t o = (size_t)(row0 + i) * B + s0 + t;
      v = Y[o];
#pragma unroll (U)
      for (int j = 0; j < st; ++j) {
        const float a = Tb.a[st][j];
        if (a != 0.f) v = fmaf(dt_use * a, K[j * RB + o], v);
      }
    }
    dst[t * zp + i] = v;
  }
}

// kst[row0 + i][s0 + t] = src[t * pitch + i] for i < nrows, t < nv.
__device__ inline void tile_store(const float* src, int pitch, int nrows, float* kst, int row0, int B, int s0,
                                  int nv, int T) {
  for (int idx = threadIdx.x; idx < nrows * T; idx += blockDim.x) {
    const int i = idx / T, t = idx % T;
    if (t < nv) kst[(size_t)(row0 + i) * B + s0 + t] = src[t * pitch + i];
  }
}

// f(r, s) for each row r < R and sample s of the tile (s < B), the block's
// threads over (r, s) with s fastest.
template <class F>
__device__ __forceinline__ void tile_entries(int tile, int T, int B, int R, const F& f) {
  const int s0 = tile * T, nv = min(T, B - s0);
  for (int idx = threadIdx.x; idx < R * T; idx += blockDim.x) {
    const int t = idx % T;
    if (t < nv) f(idx / T, s0 + t);
  }
}

// The proposal Y + dt sum_i b_i K_i of the plane entry o into Yn, and its
// error's share of the sums of squares (the btilde one, and the btilde3 one
// when has3).  Returns the proposal.
template <int U>
__device__ __forceinline__ float propose(const Tableau& Tb, float dt_use, bool has3, const float* Y, const float* K,
                                         size_t RB, size_t o, float rtol, float atol, float* Yn, float* sumsq,
                                         float* sumsq3) {
  const float y = Y[o];
  float yn = y, err = 0.f, err3 = 0.f;
#pragma unroll (U)
  for (int st = 0; st < Tb.S; ++st) {
    const float k = K[st * RB + o];
    if (Tb.b[st] != 0.f) yn = fmaf(dt_use * Tb.b[st], k, yn);
    if (Tb.btilde[st] != 0.f) err = fmaf(dt_use * Tb.btilde[st], k, err);
    if (has3 && Tb.btilde3[st] != 0.f) err3 = fmaf(dt_use * Tb.btilde3[st], k, err3);
  }
  Yn[o] = yn;
  const float sc = atol + rtol * fmaxf(fabsf(y), fabsf(yn));
  const float q = err / sc;
  *sumsq = fmaf(q, q, *sumsq);
  if (has3) {
    const float q3 = err3 / sc;
    *sumsq3 = fmaf(q3, q3, *sumsq3);
  }
  return yn;
}

// The forward solve of forward_solve with a tile field:
// `field(s0, nv, Z, KY, KR)` evaluates the rows t < T of the tile at
// samples s0 .. s0 + nv - 1 from Z (T, tile_pitch(dz)) into KY (same) and
// the accumulator rates KR (T, NACC), block-wide, ending with a barrier.
// scratch: T (2 tile_pitch(dz) + NACC) floats of shared memory for Z, KY
// and KR.
template <int NACC, int U, class Field>
__device__ void forward_solve_tiles(const FwdArgs& p, const Field& field, int T, float* scratch, float* red) {
  cg::grid_group grid = cg::this_grid();
  const Tableau& Tb = share_tableau(p.tab);
  const int S = Tb.S;
  const bool has3 = Tb.has3 != 0;
  const bool fsal = Tb.fsal != 0;
  const int dz = p.dz, B = p.B, R = dz + NACC, zp = tile_pitch(dz);
  const int ntiles = (B + T - 1) / T;
  const size_t RB = (size_t)R * B;
  float* Y = p.work;
  float* Yn = Y + RB;
  float* K = Yn + RB;
  float* Z = scratch;
  float* KY = Z + T * zp;
  float* KR = KY + T * zp;

  // Stage st of the tile (st = 0: the field at Y) into the plane K[st].
  auto eval = [&](int tile, int st, float dt_use) {
    const int s0 = tile * T, nv = min(T, B - s0);
    tile_stage_input<U>(Tb, st, dt_use, Y, K, RB, B, 0, dz, s0, nv, T, Z, zp);
    __syncthreads();
    field(s0, nv, Z, KY, KR);
    float* kst = K + st * RB;
    tile_store(KY, zp, dz, kst, 0, B, s0, nv, T);
    tile_store(KR, NACC, NACC, kst, dz, B, s0, nv, T);
    __syncthreads();
  };

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    tile_entries(tile, T, B, R, [&](int r, int s) {
      Y[(size_t)r * B + s] = r < dz ? p.z0[(size_t)s * dz + r] : p.acc0[(size_t)(r - dz) * B + s];
    });
    __syncthreads();
    eval(tile, 0, 0.f);
  }

  Controller c;
  c.init(p.ts, p.beta1, p.beta2, p.inv_order);
  const float n_elems = (float)RB;
  float dt_taken = 0.f;

  while (c.running(p.max_steps)) {
    bool is_last;
    const float dt_use = c.plan(&is_last);
    dt_taken = dt_use;

    float sumsq = 0.f, sumsq3 = 0.f;
    bool finite = true;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
#pragma unroll 1
      for (int st = 1; st < S; ++st) eval(tile, st, dt_use);
      tile_entries(tile, T, B, R, [&](int r, int s) {
        const float yn = propose<U>(Tb, dt_use, has3, Y, K, RB, (size_t)r * B + s, p.rtol, p.atol, Yn, &sumsq,
                                    &sumsq3);
        finite = finite && isfinite(yn);
      });
    }

    const int par = c.steps & 1;
    write_block_partial(sumsq, sumsq3, has3, finite, p.partials, par, red);
    grid.sync();
    float total, total3;
    bool all_finite;
    read_grid_total(p.partials, par, has3, red, &total, &total3, &all_finite);
    float eest = sqrtf(total / n_elems);
    if (has3) eest = stretched_eest(eest, sqrtf(total3 / n_elems));
    if (c.update(eest, all_finite, dt_use, is_last)) {
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        tile_entries(tile, T, B, R, [&](int r, int s) {
          const size_t o = (size_t)r * B + s;
          Y[o] = Yn[o];
          if (fsal) K[o] = K[(S - 1) * RB + o];
        });
        if (!fsal) {
          __syncthreads();
          eval(tile, 0, 0.f);
        }
      }
    }
    __syncthreads();
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    tile_entries(tile, T, B, R, [&](int r, int s) {
      const float v = Y[(size_t)r * B + s];
      if (r < dz)
        p.zT[(size_t)s * dz + r] = v;
      else
        p.accT[(size_t)(r - dz) * B + s] = v;
    });
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.stats[0] = c.steps;
    p.stats[1] = c.accepted;
    p.dt_last[0] = c.dt;
    p.dt_last[1] = dt_taken;
  }
}

// The backsolve of adjoint_solve with a tile stage.
// `stage(s0, nv, Z, AZ, KZ, KR, KAZ)` evaluates the augmented stage of the
// tile's rows from Z and AZ ((T, tile_pitch(dz)): z and a_z) into KZ, KAZ
// (the same: the field and k_az = -ct_z) and KR (T, NACC), block-wide,
// ending with a barrier, and leaves in shared memory what
// `grad(q, nv)` reads: the tile's sum over its first nv rows of the negated
// g rate entry q.  scratch: T (4 tile_pitch(dz) + NACC) floats of shared
// memory, and T p.nc more in a COND instance.  NACC: the accumulator rows,
// 3 in TRAIN mode and 1 in TEST mode (wide K5), as in adjoint_solve.
//
// COND (K8: the COND instances of the wide K2 chain form, wide K5 and the
// wide K4 adjoint): the per-sample a_ys block of a conditional net, as
// adjoint_solve's COND form and the JAX package's adjoint kernel (fused_solve.py::
// _make_adjoint_kernel: k_ays = -ct_zin[dz:] :1167, a_ys from 0 :1183,
// combined like a_z :1240, in the one batch-global norm :1270, a_ys0
// returned :1324).  The stage takes an eighth argument KYS (T, p.nc) for
// k_ays; its p.nc rows ride in the (row, B) planes after a_z but are never
// staged back into the stage's input, and a_ys0 goes to p.ays0 (B, p.nc).
// Force-inlined: the wide K2 chain form's COND instance, the largest caller,
// was left a call, which copied its kernel arguments to a 1,480-byte stack
// frame and made it 17 % slower a step on the H100.  Forced for every
// caller, it also took streamed K2 8-10 % faster and streamed K5 3 % slower
// (PERF.md); a wrapper that forced it for the COND instances alone was left
// a call in the others, 12-42 % slower.
//
// The g reduction.  Each block adds its samples' b-, btilde- (and, for
// dop853, btilde3-) weighted g rates into its own vectors of gblk
// ([gridDim.x][(NG + 2) Pg]: GB | GE | GE3 | two stage-rate partials: stage
// 1's and the last stage's, swapped on an FSAL accept).  After the grid
// barrier block b reduces only its slice q0 .. q1 - 1 of g (Pg / gridDim.x
// entries): it sums all blocks' vectors there in block order, writes the
// proposal to gnew and its slice's error sum of squares into the partials,
// and a second grid barrier makes those visible: every block then adds the
// per-sample sums and the slice sums in block order, so every block holds
// the same norm and takes the same decision.  A block reads NG Pg floats of
// vectors per attempted step, where adjoint_solve's every block reads all
// G NG Pg (58 MB a step at the MINIBOONE width).  g itself lives in gcur
// (Pg floats, global), each entry read and written by its slice's block
// only; on return it holds the gradient.  partials: [parity][sum | sum3 |
// flag | gsum | gsum3][gridDim.x].  GB and GE need no parity: a block
// rewrites them only after the second barrier, which every block reaches
// after its slice's sums.
//
// PROBES (K6: the wide K2 chain form's probe instance, K probes a sample):
// the tile arrays hold one probe's residuals, so a tile's stage runs in
// sub-passes, adjoint_solve's PROBES form for a tile.  The block calls
// `stage.probes(s0, nv, Z, AZ, KZ, KR, KAZ, flush)`, which calls `flush()`
// after each probe has left its residuals in the tile arrays; a flush adds
// the tile's probe terms `grad.probe(q, nv)` of every entry q into the b-,
// btilde- (and btilde3-) weighted vectors and the stage-rate partial, and
// after the stage the forward chain's `grad.fwd(q, nv)` follows: the
// sub-passes sum to the stage's g rate (in another order).  PROBES and COND
// together (K6 x K8: the wide K2 chain form's probe COND instance): the
// stage's `probes` takes KYS after `flush`, and k_ays is stored with the
// stage's other rates after its last sub-pass.
template <int U, bool PROBES = false, int NACC = 3, bool COND = false, class Stage, class Grad>
__device__ __forceinline__ void adjoint_solve_tiles(const AdjState& p, const Stage& stage, const Grad& grad, int Pg,
                                                    int T, float* scratch, float* gblk, float* gcur, float* gnew,
                                                    float* red) {
  cg::grid_group grid = cg::this_grid();
  const Tableau& Tb = share_tableau(p.tab);
  __shared__ float gtot[2];
  const int S = Tb.S;
  const bool has3 = Tb.has3 != 0;
  const bool fsal = Tb.fsal != 0;
  const int NG = has3 ? 3 : 2;
  const int dz = p.dz, B = p.B, G = gridDim.x, zp = tile_pitch(dz);
  const int ntiles = (B + T - 1) / T;
  const int nc = COND ? p.nc : 0;
  const int R = 2 * dz + NACC + nc;  // rows: z, acc, a_z, a_ys
  const size_t RB = (size_t)R * B;
  float* Y = p.work;
  float* Yn = Y + RB;
  float* K = Yn + RB;
  float* Z = scratch;
  float* AZ = Z + T * zp;
  float* KZ = AZ + T * zp;
  float* KAZ = KZ + T * zp;
  float* KR = KAZ + T * zp;
  float* KYS = KR + T * NACC;  // COND: k_ays (T, nc)
  const size_t bstride = (size_t)(NG + 2) * Pg;
  float* GB = gblk + blockIdx.x * bstride;
  float* GE = GB + Pg;
  float* GE3 = GE + Pg;
  float* k1p = GB + (size_t)NG * Pg;  // this block's stage-1 g rate partial
  float* k7p = k1p + Pg;              // and its last stage's
  const int q0 = (int)((long long)Pg * blockIdx.x / G), q1 = (int)((long long)Pg * (blockIdx.x + 1) / G);

  // Stage st of the tile (st = 0: at Y) into the plane K[st].  (The stage
  // comes in as an argument so that a PROBES instance, whose stage has only
  // `probes`, never instantiates the call.)
  auto eval = [&](const auto& stg, int tile, int st, float dt_use) {
    const int s0 = tile * T, nv = min(T, B - s0);
    tile_stage_input<U>(Tb, st, dt_use, Y, K, RB, B, 0, dz, s0, nv, T, Z, zp);
    tile_stage_input<U>(Tb, st, dt_use, Y, K, RB, B, dz + NACC, dz, s0, nv, T, AZ, zp);
    __syncthreads();
    if constexpr (COND)
      stg(s0, nv, Z, AZ, KZ, KR, KAZ, KYS);
    else
      stg(s0, nv, Z, AZ, KZ, KR, KAZ);
    float* kst = K + st * RB;
    tile_store(KZ, zp, dz, kst, 0, B, s0, nv, T);
    tile_store(KR, NACC, NACC, kst, dz, B, s0, nv, T);
    tile_store(KAZ, zp, dz, kst, dz + NACC, B, s0, nv, T);
    if constexpr (COND) tile_store(KYS, nc, nc, kst, 2 * dz + NACC, B, s0, nv, T);
    return nv;
  };
  // PROBES: eval in its sub-passes; `pass(term)` adds one sub-pass's g rate
  // entries term(q) of the tile into the block's vectors.
  auto eval_probes = [&](const auto& stg, const auto& grd, int tile, int st, float dt_use, const auto& pass) {
    const int s0 = tile * T, nv = min(T, B - s0);
    tile_stage_input<U>(Tb, st, dt_use, Y, K, RB, B, 0, dz, s0, nv, T, Z, zp);
    tile_stage_input<U>(Tb, st, dt_use, Y, K, RB, B, dz + NACC, dz, s0, nv, T, AZ, zp);
    __syncthreads();
    auto flush = [&]() {
      __syncthreads();
      pass([&](int q) { return grd.probe(q, nv); });
      __syncthreads();
    };
    if constexpr (COND)
      stg.probes(s0, nv, Z, AZ, KZ, KR, KAZ, flush, KYS);
    else
      stg.probes(s0, nv, Z, AZ, KZ, KR, KAZ, flush);
    float* kst = K + st * RB;
    tile_store(KZ, zp, dz, kst, 0, B, s0, nv, T);
    tile_store(KR, NACC, NACC, kst, dz, B, s0, nv, T);
    tile_store(KAZ, zp, dz, kst, dz + NACC, B, s0, nv, T);
    if constexpr (COND) tile_store(KYS, nc, nc, kst, 2 * dz + NACC, B, s0, nv, T);
    pass([&](int q) { return grd.fwd(q, nv); });
    __syncthreads();
  };
  // Stage 1 at the current state, its g rate partial into k1p.
  auto stage1 = [&]() {
    for (int q = threadIdx.x; q < Pg; q += blockDim.x) k1p[q] = 0.f;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      if constexpr (PROBES) {
        eval_probes(stage, grad, tile, 0, 0.f, [&](const auto& term) {
          for (int q = threadIdx.x; q < Pg; q += blockDim.x) k1p[q] += term(q);
        });
      } else {
        const int nv = eval(stage, tile, 0, 0.f);
        for (int q = threadIdx.x; q < Pg; q += blockDim.x) k1p[q] += grad(q, nv);
        __syncthreads();
      }
    }
  };

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    if constexpr (COND) {
      tile_entries(tile, T, B, R, [&](int r, int s) {
        Y[(size_t)r * B + s] = r < dz              ? p.zT[(size_t)s * dz + r]
                               : r < dz + NACC     ? p.accT[(size_t)(r - dz) * B + s]
                               : r < 2 * dz + NACC ? p.azT[(size_t)s * dz + r - dz - NACC]
                                                   : 0.f;  // a_ys starts at 0
      });
    } else {
      tile_entries(tile, T, B, R, [&](int r, int s) {
        Y[(size_t)r * B + s] = r < dz          ? p.zT[(size_t)s * dz + r]
                               : r < dz + NACC ? p.accT[(size_t)(r - dz) * B + s]
                                               : p.azT[(size_t)s * dz + r - dz - NACC];
      });
    }
  }
  for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) gcur[q] = 0.f;
  __syncthreads();
  stage1();

  Controller c;
  c.init(p.ts, p.beta1, p.beta2, p.inv_order);
  const float n_elems = (float)B * (float)(2 * (dz + NACC) + nc) + (float)Pg;

  while (c.running(p.max_steps)) {
    bool is_last;
    const float dt_use = c.plan(&is_last);
    const int par = c.steps & 1;
    const float cb0 = dt_use * Tb.b[0], ce0 = dt_use * Tb.btilde[0], ce30 = dt_use * Tb.btilde3[0];
    for (int q = threadIdx.x; q < Pg; q += blockDim.x) {
      GB[q] = cb0 * k1p[q];
      GE[q] = ce0 * k1p[q];
      if (has3) GE3[q] = ce30 * k1p[q];
      k7p[q] = 0.f;
    }

    float sumsq = 0.f, sumsq3 = 0.f;
    bool finite = true;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
#pragma unroll 1
      for (int st = 1; st < S; ++st) {
        if constexpr (PROBES) {
          const float bs = Tb.b[st], bt = Tb.btilde[st], bt3 = Tb.btilde3[st];
          const float cb = dt_use * bs, ce = dt_use * bt, ce3 = dt_use * bt3;
          const bool last = fsal && st == S - 1;
          // One sub-pass's g rate entries term(q) into GB, GE (GE3) and k7p,
          // kG entries a thread at a time as below.  (The one-probe path
          // keeps its own copy of the loop: through this lambda its SASS
          // changed, and it compiles as it did before the probe instance.)
          auto add_rates = [&](const auto& term) {
            constexpr int kG = 4;
            for (int q0 = threadIdx.x; q0 < Pg; q0 += kG * blockDim.x) {
              float vb[kG], ve[kG], ve3[kG], v7[kG];
#pragma unroll
              for (int j = 0; j < kG; ++j) {
                const int q = q0 + j * blockDim.x;
                if (q >= Pg) continue;
                vb[j] = GB[q];
                ve[j] = GE[q];
                if (has3) ve3[j] = GE3[q];
                if (last) v7[j] = k7p[q];
              }
#pragma unroll
              for (int j = 0; j < kG; ++j) {
                const int q = q0 + j * blockDim.x;
                if (q >= Pg) continue;
                const float g = term(q);
                if (bs != 0.f) GB[q] = fmaf(cb, g, vb[j]);
                if (bt != 0.f) GE[q] = fmaf(ce, g, ve[j]);
                if (has3 && bt3 != 0.f) GE3[q] = fmaf(ce3, g, ve3[j]);
                if (last) k7p[q] = v7[j] + g;
              }
            }
          };
          eval_probes(stage, grad, tile, st, dt_use, add_rates);
        } else {
          const int nv = eval(stage, tile, st, dt_use);
          const float bs = Tb.b[st], bt = Tb.btilde[st], bt3 = Tb.btilde3[st];
          const float cb = dt_use * bs, ce = dt_use * bt, ce3 = dt_use * bt3;
          const bool last = fsal && st == S - 1;
          // kG entries a thread at a time: their global vectors are loaded
          // before the rates are summed, so the loads' latency overlaps.
          constexpr int kG = 4;
          for (int q0 = threadIdx.x; q0 < Pg; q0 += kG * blockDim.x) {
            float vb[kG], ve[kG], ve3[kG], v7[kG];
#pragma unroll
            for (int j = 0; j < kG; ++j) {
              const int q = q0 + j * blockDim.x;
              if (q >= Pg) continue;
              vb[j] = GB[q];
              ve[j] = GE[q];
              if (has3) ve3[j] = GE3[q];
              if (last) v7[j] = k7p[q];
            }
#pragma unroll
            for (int j = 0; j < kG; ++j) {
              const int q = q0 + j * blockDim.x;
              if (q >= Pg) continue;
              const float g = grad(q, nv);
              if (bs != 0.f) GB[q] = fmaf(cb, g, vb[j]);
              if (bt != 0.f) GE[q] = fmaf(ce, g, ve[j]);
              if (has3 && bt3 != 0.f) GE3[q] = fmaf(ce3, g, ve3[j]);
              if (last) k7p[q] = v7[j] + g;
            }
          }
          __syncthreads();
        }
      }
      // The tile's proposals and errors: z, acc, a_z (and a_ys) rows (a_acc
      // is constant: zero error, but counted in n_elems).
      tile_entries(tile, T, B, R, [&](int r, int s) {
        const float yn = propose<U>(Tb, dt_use, has3, Y, K, RB, (size_t)r * B + s, p.rtol, p.atol, Yn, &sumsq,
                                    &sumsq3);
        if (r < dz || r >= dz + NACC) finite = finite && isfinite(yn);
      });
    }

    float* slots = p.partials + (size_t)(5 * par) * G;
    write_block_partial(sumsq, sumsq3, has3, finite, slots, 0, red);
    grid.sync();
    // This block's slice of g: all blocks' vectors summed in block order.
    float gsq = 0.f, gsq3 = 0.f;
    for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
      float gs = 0.f, es = 0.f, es3 = 0.f;
#pragma unroll 8
      for (int g = 0; g < G; ++g) {
        const float* base = gblk + g * bstride;
        gs += __ldcg(base + q);
        es += __ldcg(base + Pg + q);
        if (has3) es3 += __ldcg(base + 2 * Pg + q);
      }
      const float gn = gcur[q] + gs;
      gnew[q] = gn;
      const float sc = p.atol + p.rtol * fmaxf(fabsf(gcur[q]), fabsf(gn));
      const float qv = es / sc;
      gsq = fmaf(qv, qv, gsq);
      if (has3) {
        const float q3 = es3 / sc;
        gsq3 = fmaf(q3, q3, gsq3);
      }
    }
    gsq = block_sum(gsq, red);
    if (has3) gsq3 = block_sum(gsq3, red);
    if (threadIdx.x == 0) {
      slots[3 * G + blockIdx.x] = gsq;
      slots[4 * G + blockIdx.x] = gsq3;
    }
    grid.sync();
    float total, total3;
    bool all_finite;
    read_grid_total(slots, 0, has3, red, &total, &total3, &all_finite);
    if (threadIdx.x == 0) {
      float tg = 0.f, tg3 = 0.f;
      for (int g = 0; g < G; ++g) tg += __ldcg(slots + 3 * G + g);
      if (has3)
        for (int g = 0; g < G; ++g) tg3 += __ldcg(slots + 4 * G + g);
      gtot[0] = tg;
      gtot[1] = tg3;
    }
    __syncthreads();
    float eest = sqrtf((total + gtot[0]) / n_elems);
    if (has3) eest = stretched_eest(eest, sqrtf((total3 + gtot[1]) / n_elems));
    __syncthreads();
    if (c.update(eest, all_finite, dt_use, is_last)) {
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        tile_entries(tile, T, B, R, [&](int r, int s) {
          const size_t off = (size_t)r * B + s;
          Y[off] = Yn[off];
          if (fsal) K[off] = K[(S - 1) * RB + off];
        });
      }
      for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) gcur[q] = gnew[q];
      if (fsal) {
        float* tmp = k1p;
        k1p = k7p;
        k7p = tmp;
      } else {
        __syncthreads();
        stage1();
      }
    }
    __syncthreads();
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    if constexpr (COND) {
      tile_entries(tile, T, B, R, [&](int r, int s) {
        const float v = Y[(size_t)r * B + s];
        if (r < dz)
          p.z0[(size_t)s * dz + r] = v;
        else if (r < dz + NACC)
          p.acc0[(size_t)(r - dz) * B + s] = v;
        else if (r < 2 * dz + NACC)
          p.az0[(size_t)s * dz + r - dz - NACC] = v;
        else
          p.ays0[(size_t)s * nc + r - 2 * dz - NACC] = v;
      });
    } else {
      tile_entries(tile, T, B, R, [&](int r, int s) {
        const float v = Y[(size_t)r * B + s];
        if (r < dz)
          p.z0[(size_t)s * dz + r] = v;
        else if (r < dz + NACC)
          p.acc0[(size_t)(r - dz) * B + s] = v;
        else
          p.az0[(size_t)s * dz + r - dz - NACC] = v;
      });
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.stats[0] = c.steps;
    p.stats[1] = c.accepted;
  }
}

// Fill the FwdArgs fields from the forward kernels' C arguments (the net's
// weights go in separately).
inline void set_fwd_args(FwdArgs* a, const float* eps, const float* z0, const float* acc0, const float* ts,
                         float* zT, float* accT, int* stats, float* dt_last, float* work, float* partials,
                         int B, int dz, int max_steps, int norm_z, int norm_j, float rtol, float atol,
                         float beta1, float beta2, float inv_order, const float* tab) {
  *a = FwdArgs{};
  a->eps = eps;
  a->z0 = z0; a->acc0 = acc0; a->ts = ts;
  a->zT = zT; a->accT = accT; a->stats = stats; a->dt_last = dt_last;
  a->work = work; a->partials = partials;
  a->B = B; a->dz = dz; a->max_steps = max_steps; a->norm_z = norm_z; a->norm_j = norm_j;
  a->rtol = rtol; a->atol = atol; a->beta1 = beta1; a->beta2 = beta2; a->inv_order = inv_order;
  read_tableau(tab, &a->tab);
}

// Fill the AdjState fields from the adjoint kernels' C arguments (nc = 0:
// the K2 chain form sets nc and ays0 itself).
inline void set_adj_state(AdjState* a, const float* zT, const float* accT, const float* azT,
                          const float* aaccT, const float* ts, float* z0, float* acc0, float* az0,
                          int* stats, float* work, float* partials, float* gpart, int B, int dz,
                          int max_steps, float rtol, float atol, float beta1, float beta2,
                          float inv_order, const float* tab) {
  *a = AdjState{};
  a->zT = zT; a->accT = accT; a->azT = azT; a->aaccT = aaccT; a->ts = ts;
  a->z0 = z0; a->acc0 = acc0; a->az0 = az0; a->stats = stats;
  a->work = work; a->partials = partials; a->gpart = gpart;
  a->B = B; a->dz = dz; a->max_steps = max_steps;
  a->rtol = rtol; a->atol = atol; a->beta1 = beta1; a->beta2 = beta2; a->inv_order = inv_order;
  read_tableau(tab, &a->tab);
}

// Largest co-resident grid of `kernel` for a cooperative launch (0 if the
// device cannot launch cooperatively or the block does not fit).  A block
// that asks for more shared memory than the device gives one is refused
// before any runtime call, and a failed call's error is cleared, so a probe
// leaves no error behind for a later cudaGetLastError (the launch's, or
// PyTorch's own checks) to report.
template <class Kernel>
cudaError_t coop_max_grid(Kernel kernel, size_t smem, int block, int* out) {
  *out = 0;
  int dev = 0, sms = 0, coop = 0, per_sm = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess && smem > (size_t)optin) return cudaErrorInvalidValue;
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && coop) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  *out = per_sm * sms;
  return cudaSuccess;
}

template <class Kernel, class A>
cudaError_t coop_launch(Kernel kernel, const A& a, int grid, int block, size_t smem,
                        cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  A args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(block), params, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace cnf
