// Shared pieces of the solve kernels (K3, K1, K2): the tsit5 tableau, the PI
// step-size controller, the fixed-order block and grid reductions that give
// every block bitwise the same error norm, the cooperative-launch helpers,
// and the whole adaptive forward solve of a per-sample field (K3 and K1).
//
// The forward solve keeps the state [z (dz rows) | accumulators (NACC rows)]
// in a global scratch laid out (row, B), so a warp's accesses are coalesced.
// One thread owns one sample at a time (threads stride over samples beyond
// the co-resident grid); the controller state is held, and updated
// identically, by every thread.  One grid.sync() per attempted step: each
// block writes its partial error sum and finite flag into a buffer chosen by
// step parity, and after the barrier every block sums all partials in the
// same order.  A block can only overwrite a parity's buffer after the next
// step's barrier, which every block reaches only once it has read it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cnf {

namespace cg = cooperative_groups;

constexpr int kStages = 7;   // tsit5, FSAL: stage 7 is f at the proposed point
constexpr int kMaxBlock = 256;
constexpr int kRedFloats = 2 * 32 + 2;  // per-warp sums, per-warp flags, broadcast

struct Tableau {
  float a[kStages][kStages];  // a[i][j] for j < i
  float b[kStages];
  float btilde[kStages];
};

// tab: a (kStages x kStages, row-major) | b | btilde, as the wrappers pass it.
inline void read_tableau(const float* tab, Tableau* t) {
  for (int i = 0; i < kStages; ++i) {
    for (int j = 0; j < kStages; ++j) t->a[i][j] = tab[i * kStages + j];
    t->b[i] = tab[kStages * kStages + i];
    t->btilde[i] = tab[kStages * kStages + kStages + i];
  }
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
    red[64] = s;
  }
  __syncthreads();
  return red[64];
}

// Write this block's partial error sum and finite flag (1 or 0) into the
// parity's slots of `partials` ([parity][sum | flag][gridDim.x]).
__device__ inline void write_block_partial(float sumsq, bool finite, float* partials, int par,
                                           float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  float v = sumsq;
  float fl = finite ? 1.f : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
    fl = fminf(fl, __shfl_down_sync(0xffffffffu, fl, off));
  }
  if (lane == 0) {
    red[warp] = v;
    red[32 + warp] = fl;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bsum = 0.f, bflag = 1.f;
    for (int w = 0; w < nwarps; ++w) {
      bsum += red[w];
      bflag = fminf(bflag, red[32 + w]);
    }
    float* psum = partials + (size_t)(2 * par) * gridDim.x;
    psum[blockIdx.x] = bsum;
    psum[gridDim.x + blockIdx.x] = bflag;
  }
}

// After the grid barrier: the sum of all blocks' partials and whether all
// were finite, summed in block order by every block (so bitwise equal).
__device__ inline void read_grid_total(const float* partials, int par, float* red, float* total,
                                       bool* all_finite) {
  const float* psum = partials + (size_t)(2 * par) * gridDim.x;
  if (threadIdx.x == 0) {
    float tot = 0.f, all = 1.f;
    for (int g = 0; g < (int)gridDim.x; ++g) {
      tot += __ldcg(psum + g);
      all = fminf(all, __ldcg(psum + gridDim.x + g));
    }
    red[64] = tot;
    red[65] = all;
  }
  __syncthreads();
  *total = red[64];
  *all_finite = red[65] > 0.5f;
  __syncthreads();
}

// Arguments of the forward solve kernels (K3: NACC = 1, K1: NACC = 3).
struct FwdArgs {
  const float* w1;    // (dz, H), layer 1 computes z @ w1 + b1
  const float* b1;    // (H)
  const float* w2;    // (H, dz)
  const float* b2;    // (dz)
  const float* eps;   // (B, dz) Hutchinson probe (K1), unused by K3
  const float* z0;    // (B, dz)
  const float* acc0;  // (NACC, B) accumulators the solve starts from
  const float* ts;    // t0, t1, dt_init
  float* zT;          // (B, dz)
  float* accT;        // (NACC, B)
  int* stats;         // attempted, accepted
  float* dt_last;     // (1)
  float* work;        // (kStages + 2) * (dz + NACC) * B
  float* partials;    // [parity][sum | flag][gridDim.x]
  int B, dz, H, max_steps, norm_z, norm_j;
  float rtol, atol, beta1, beta2, inv_order;
  Tableau tab;
};

// The whole adaptive solve of [z | acc] from ts[0] to ts[1].  `field(s, z,
// ky, kr)` evaluates sample s's field at z: ky (DZ) and the accumulator
// rates kr (NACC); z is zero beyond dz and ky must be too.  red: kRedFloats
// floats of shared memory.
template <int DZ, int NACC, class Field>
__device__ void forward_solve(const FwdArgs& p, const Field& field, float* red) {
  cg::grid_group grid = cg::this_grid();
  const int dz = p.dz, B = p.B, R = dz + NACC;
  const int nthr = gridDim.x * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t RB = (size_t)R * B;  // one (row, B) plane
  float* Y = p.work;                // current state: z rows, then the accumulator rows
  float* Yn = Y + RB;               // proposed state
  float* K = Yn + RB;               // stage registers, kStages planes

  // Initial state (accumulators seeded from acc0) and the first stage.
  for (int s = gtid; s < B; s += nthr) {
    float z[DZ], ky[DZ], kr[NACC];
#pragma unroll
    for (int i = 0; i < DZ; ++i) z[i] = i < dz ? p.z0[(size_t)s * dz + i] : 0.f;
    field(s, z, ky, kr);
#pragma unroll
    for (int i = 0; i < DZ; ++i) {
      if (i < dz) {
        Y[(size_t)i * B + s] = z[i];
        K[(size_t)i * B + s] = ky[i];
      }
    }
#pragma unroll
    for (int r = 0; r < NACC; ++r) {
      Y[(size_t)(dz + r) * B + s] = p.acc0[(size_t)r * B + s];
      K[(size_t)(dz + r) * B + s] = kr[r];
    }
  }

  Controller c;
  c.init(p.ts, p.beta1, p.beta2, p.inv_order);
  const float n_elems = (float)RB;

  while (c.running(p.max_steps)) {
    bool is_last;
    const float dt_use = c.plan(&is_last);

    float sumsq = 0.f;
    bool finite = true;
    for (int s = gtid; s < B; s += nthr) {
#pragma unroll
      for (int st = 1; st < kStages; ++st) {
        float z[DZ], ky[DZ], kr[NACC];
#pragma unroll
        for (int i = 0; i < DZ; ++i) z[i] = i < dz ? Y[(size_t)i * B + s] : 0.f;
#pragma unroll
        for (int j = 0; j < st; ++j) {
          if (p.tab.a[st][j] != 0.f) {
            const float cf = dt_use * p.tab.a[st][j];
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
      }
      for (int r = 0; r < R; ++r) {
        const size_t o = (size_t)r * B + s;
        const float y = Y[o];
        float yn = y, err = 0.f;
#pragma unroll
        for (int st = 0; st < kStages; ++st) {
          const float k = K[st * RB + o];
          if (p.tab.b[st] != 0.f) yn = fmaf(dt_use * p.tab.b[st], k, yn);
          if (p.tab.btilde[st] != 0.f) err = fmaf(dt_use * p.tab.btilde[st], k, err);
        }
        Yn[o] = yn;
        const float q = err / (p.atol + p.rtol * fmaxf(fabsf(y), fabsf(yn)));
        sumsq = fmaf(q, q, sumsq);
        finite = finite && isfinite(yn);
      }
    }

    const int par = c.steps & 1;
    write_block_partial(sumsq, finite, p.partials, par, red);
    grid.sync();
    float total;
    bool all_finite;
    read_grid_total(p.partials, par, red, &total, &all_finite);
    if (c.update(sqrtf(total / n_elems), all_finite, dt_use, is_last)) {
      // Accept: the proposed state and, FSAL, the last stage become current.
      for (int s = gtid; s < B; s += nthr) {
        for (int r = 0; r < R; ++r) {
          const size_t o = (size_t)r * B + s;
          Y[o] = Yn[o];
          K[o] = K[(kStages - 1) * RB + o];
        }
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
  }
}

// Largest co-resident grid of `kernel` for a cooperative launch (0 if the
// device cannot launch cooperatively or the block does not fit).
template <class Kernel>
cudaError_t coop_max_grid(Kernel kernel, size_t smem, int block, int* out) {
  *out = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if (!coop) return cudaSuccess;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem);
  if (e != cudaSuccess) return e;
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
