// K3: the TEST-mode forward solve of a CNF whose field is a 2-layer tanh MLP,
// the whole adaptive tsit5 solve in one cooperative launch.
//
// Replaces the TPU kernel continuousnf_tpu/ops/fused_solve.py::_run_solve_kernel
// (pl.pallas_call at :1043) built by _make_solve_kernel (:773-942) with the
// _stage_test stage (:484-503).  What it computes, per attempted step:
//   * the tsit5 stages of the state [z (B, dz) | dlogp (B)], where the field
//     is y = tanh(tanh(z W1 + b1) W2 + b2) and the dlogp rate is
//     -tr J = -sum_i dy_i (M dh)_i, M[i, h] = W1[i, h] W2[h, i];
//   * the embedded error and ONE Hairer norm over all B * (dz + 1) elements
//     (the step control is batch-global, as in ode/solve.py::_attempt_step);
//   * a global finite flag over the proposed state;
//   * the PI controller, FSAL, and the max_steps cap.
// The accumulator row is seeded from the incoming dlogp (the TPU kernel
// starts it at zero, fused_solve.py:836-838; that fault is not copied).
//
// What bounds it on the H100: latency, not bytes or FLOPs.  A stage costs
// about 3 * dz * H FMA per sample (2.3 k at dz = 16, H = 48): at B = 4096 a
// whole stage is ~10 MFLOP, microseconds of one SM's work, so the time goes to
// the dependent FMA chains of each thread and to one grid-wide barrier per
// attempted step.  The design follows from that:
//   * one thread per sample (threads stride over samples when B exceeds the
//     co-resident grid), 128 threads per block: fewer blocks make the
//     per-step barrier and partial sum cheaper, which measured faster than
//     spreading single warps over all SMs;
//   * W1, b1, W2, b2 and M live in shared memory, padded to DZ columns and
//     read with 16-byte broadcast loads; the per-sample state and the stage
//     registers live in a global scratch laid out (row, B), so a warp's
//     accesses are coalesced and stay in L1/L2;
//   * one cooperative grid.sync() per attempted step: each block writes its
//     partial error sum and finite flag into a buffer chosen by step parity,
//     and after the barrier EVERY block sums all partials in the same fixed
//     order.  All blocks therefore hold bitwise the same eest and take the
//     same accept/reject and step-size decisions without a second barrier.
// Precision: f32 FMA on the CUDA cores for the stages and the controller; no
// TF32 and no tensor cores.  The TPU's bf16x3 matmul split
// (fused_solve.py:183-211) is not ported: the stage dots here are exact f32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kStages = 7;     // tsit5, FSAL: stage 7 is f at the proposed point
constexpr int kMaxBlock = 256;
constexpr int kRedFloats = 2 * 32 + 2;  // per-warp sums, per-warp flags, broadcast

struct Tableau {
  float a[kStages][kStages];  // a[i][j] for j < i
  float b[kStages];
  float btilde[kStages];
};

struct Args {
  const float* w1;      // (dz, H), layer 1 computes z @ w1 + b1
  const float* b1;      // (H)
  const float* w2;      // (H, dz)
  const float* b2;      // (dz)
  const float* z0;      // (B, dz)
  const float* dlogp0;  // (B)
  const float* ts;      // t0, t1, dt_init
  float* zT;            // (B, dz)
  float* dlogpT;        // (B)
  int* stats;           // attempted, accepted
  float* dt_last;       // (1)
  float* work;          // (kStages + 2) * (dz + 1) * B
  float* partials;      // [parity][sum | flag][gridDim.x]
  int B, dz, H, max_steps;
  float rtol, atol, beta1, beta2, inv_order;
  Tableau tab;
};

// The TEST field of one sample: ky = y, kr = -tr J.  Columns i >= dz of the
// padded weights are zero, so padded inputs contribute nothing and padded
// outputs (y = tanh(0) = 0, M dh = 0) add nothing to the trace.
template <int DZ>
__device__ __forceinline__ void test_field(const float (&z)[DZ], float (&ky)[DZ], float& kr,
                                           const float* __restrict__ w1t,
                                           const float* __restrict__ b1,
                                           const float* __restrict__ w2p,
                                           const float* __restrict__ b2p,
                                           const float* __restrict__ mt, int H) {
  float pre[DZ], mdh[DZ];
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    pre[k] = b2p[k];
    mdh[k] = 0.f;
  }
  for (int j = 0; j < H; ++j) {
    const float4* w1j = reinterpret_cast<const float4*>(w1t + j * DZ);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int q = 0; q < DZ / 4; ++q) {
      const float4 w = w1j[q];
      a0 = fmaf(z[4 * q + 0], w.x, a0);
      a1 = fmaf(z[4 * q + 1], w.y, a1);
      a2 = fmaf(z[4 * q + 2], w.z, a2);
      a3 = fmaf(z[4 * q + 3], w.w, a3);
    }
    const float h = tanhf(((a0 + a1) + (a2 + a3)) + b1[j]);
    const float dh = 1.f - h * h;
    const float4* w2j = reinterpret_cast<const float4*>(w2p + j * DZ);
    const float4* mj = reinterpret_cast<const float4*>(mt + j * DZ);
#pragma unroll
    for (int q = 0; q < DZ / 4; ++q) {
      const float4 w = w2j[q];
      const float4 m = mj[q];
      pre[4 * q + 0] = fmaf(h, w.x, pre[4 * q + 0]);
      pre[4 * q + 1] = fmaf(h, w.y, pre[4 * q + 1]);
      pre[4 * q + 2] = fmaf(h, w.z, pre[4 * q + 2]);
      pre[4 * q + 3] = fmaf(h, w.w, pre[4 * q + 3]);
      mdh[4 * q + 0] = fmaf(m.x, dh, mdh[4 * q + 0]);
      mdh[4 * q + 1] = fmaf(m.y, dh, mdh[4 * q + 1]);
      mdh[4 * q + 2] = fmaf(m.z, dh, mdh[4 * q + 2]);
      mdh[4 * q + 3] = fmaf(m.w, dh, mdh[4 * q + 3]);
    }
  }
  float tr = 0.f;
#pragma unroll
  for (int k = 0; k < DZ; ++k) {
    const float y = tanhf(pre[k]);
    ky[k] = y;
    tr = fmaf(1.f - y * y, mdh[k], tr);
  }
  kr = -tr;
}

template <int DZ>
__global__ void __launch_bounds__(kMaxBlock) k3_test_solve(const Args p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, dz = p.dz, B = p.B, R = dz + 1;
  float* w1t = smem;             // (H, DZ): w1t[j][i] = w1[i][j]
  float* w2p = w1t + H * DZ;     // (H, DZ): w2p[j][k] = w2[j][k]
  float* mt = w2p + H * DZ;      // (H, DZ): mt[j][i] = w1[i][j] * w2[j][i]
  float* b2p = mt + H * DZ;      // (DZ)
  float* b1 = b2p + DZ;          // (H)
  float* red = b1 + H;           // kRedFloats

  for (int idx = threadIdx.x; idx < H * DZ; idx += blockDim.x) {
    const int j = idx / DZ, i = idx % DZ;
    const float w1v = i < dz ? p.w1[(size_t)i * H + j] : 0.f;
    const float w2v = i < dz ? p.w2[(size_t)j * dz + i] : 0.f;
    w1t[idx] = w1v;
    w2p[idx] = w2v;
    mt[idx] = w1v * w2v;
  }
  for (int k = threadIdx.x; k < DZ; k += blockDim.x) b2p[k] = k < dz ? p.b2[k] : 0.f;
  for (int j = threadIdx.x; j < H; j += blockDim.x) b1[j] = p.b1[j];
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  const int nthr = G * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t RB = (size_t)R * B;  // one (row, B) plane
  float* Y = p.work;                // current state: z rows, then the dlogp row
  float* Yn = Y + RB;               // proposed state
  float* K = Yn + RB;               // stage registers, kStages planes

  // Initial state (accumulator seeded from dlogp0) and the first stage.
  for (int s = gtid; s < B; s += nthr) {
    float z[DZ], ky[DZ], kr;
#pragma unroll
    for (int i = 0; i < DZ; ++i) z[i] = i < dz ? p.z0[(size_t)s * dz + i] : 0.f;
    test_field<DZ>(z, ky, kr, w1t, b1, w2p, b2p, mt, H);
#pragma unroll
    for (int i = 0; i < DZ; ++i) {
      if (i < dz) {
        Y[(size_t)i * B + s] = z[i];
        K[(size_t)i * B + s] = ky[i];
      }
    }
    Y[(size_t)dz * B + s] = p.dlogp0[s];
    K[(size_t)dz * B + s] = kr;
  }

  // The controller state is held, and updated identically, by every thread.
  const float t0 = p.ts[0], t1 = p.ts[1];
  float dt = p.ts[2];
  const float tdir = t1 > t0 ? 1.f : (t1 < t0 ? -1.f : 0.f);
  const float n_elems = (float)RB;
  float t = t0, eest_prev = 1.f;
  int steps = 0, accepted = 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = (blockDim.x + 31) >> 5;

  while ((t - t1) * tdir < 0.f && steps < p.max_steps) {
    const float remaining = fabsf(t1 - t);
    const bool is_last = fabsf(dt) >= remaining;
    const float dt_use = tdir * fminf(fabsf(dt), remaining);

    float sumsq = 0.f;
    bool finite = true;
    for (int s = gtid; s < B; s += nthr) {
#pragma unroll
      for (int st = 1; st < kStages; ++st) {
        float z[DZ], ky[DZ], kr;
#pragma unroll
        for (int i = 0; i < DZ; ++i) z[i] = i < dz ? Y[(size_t)i * B + s] : 0.f;
#pragma unroll
        for (int j = 0; j < st; ++j) {
          if (p.tab.a[st][j] != 0.f) {
            const float c = dt_use * p.tab.a[st][j];
            const float* kj = K + j * RB;
#pragma unroll
            for (int i = 0; i < DZ; ++i)
              if (i < dz) z[i] = fmaf(c, kj[(size_t)i * B + s], z[i]);
          }
        }
        test_field<DZ>(z, ky, kr, w1t, b1, w2p, b2p, mt, H);
        float* kst = K + st * RB;
#pragma unroll
        for (int i = 0; i < DZ; ++i)
          if (i < dz) kst[(size_t)i * B + s] = ky[i];
        kst[(size_t)dz * B + s] = kr;
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

    // Block partials, reduced in a fixed order.
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
    const int par = steps & 1;
    float* psum = p.partials + (size_t)(2 * par) * G;
    float* pflag = psum + G;
    if (threadIdx.x == 0) {
      float bsum = 0.f, bflag = 1.f;
      for (int w = 0; w < nwarps; ++w) {
        bsum += red[w];
        bflag = fminf(bflag, red[32 + w]);
      }
      psum[blockIdx.x] = bsum;
      pflag[blockIdx.x] = bflag;
    }
    grid.sync();
    // Every block sums all partials in the same order: identical eest
    // everywhere.  The parity buffers make one barrier per step enough: a
    // block can only overwrite this parity after the next step's barrier.
    if (threadIdx.x == 0) {
      float tot = 0.f, all = 1.f;
      for (int g = 0; g < G; ++g) {
        tot += __ldcg(psum + g);
        all = fminf(all, __ldcg(pflag + g));
      }
      red[64] = tot;
      red[65] = all;
    }
    __syncthreads();
    const float eest = sqrtf(red[64] / n_elems);
    const bool fin = red[65] > 0.5f && isfinite(eest);
    const bool accept = eest <= 1.f && fin;

    // PI controller (ode/solve.py::_attempt_step).
    const float eest_c = fmaxf(eest, 1e-4f);
    float q_acc = 0.9f * powf(eest_c, -p.beta1) * powf(eest_prev, p.beta2);
    if (!isfinite(q_acc)) q_acc = 0.2f;
    float q_rej = 0.9f * powf(eest_c, -p.inv_order);
    if (!isfinite(q_rej) || !fin) q_rej = 0.2f;
    const float dt_next = accept ? dt_use * fminf(fmaxf(q_acc, 0.2f), 10.f)
                                 : dt_use * fminf(fmaxf(q_rej, 0.2f), 1.f);
    if (accept) {
      // Accept: the proposed state and, FSAL, the last stage become current.
      for (int s = gtid; s < B; s += nthr) {
        for (int r = 0; r < R; ++r) {
          const size_t o = (size_t)r * B + s;
          Y[o] = Yn[o];
          K[o] = K[(kStages - 1) * RB + o];
        }
      }
      t = is_last ? t1 : t + dt_use;
      eest_prev = eest_c;
      ++accepted;
    }
    dt = dt_next;
    ++steps;
  }

  for (int s = gtid; s < B; s += nthr) {
    for (int i = 0; i < dz; ++i) p.zT[(size_t)s * dz + i] = Y[(size_t)i * B + s];
    p.dlogpT[s] = Y[(size_t)dz * B + s];
  }
  if (gtid == 0) {
    p.stats[0] = steps;
    p.stats[1] = accepted;
    p.dt_last[0] = dt;
  }
}

template <int DZ>
size_t smem_bytes(int H) {
  return sizeof(float) * (3 * (size_t)H * DZ + DZ + H + kRedFloats);
}

template <int DZ>
cudaError_t max_grid(int H, int block, int* out) {
  *out = 0;
  const size_t smem = smem_bytes<DZ>(H);
  cudaError_t e = cudaFuncSetAttribute(k3_test_solve<DZ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if (!coop) return cudaSuccess;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k3_test_solve<DZ>, block, smem);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

template <int DZ>
cudaError_t launch(const Args& a, int grid, int block, cudaStream_t stream) {
  const size_t smem = smem_bytes<DZ>(a.H);
  cudaError_t e = cudaFuncSetAttribute(k3_test_solve<DZ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  Args args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)k3_test_solve<DZ>, dim3(grid), dim3(block), params,
                                  smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// The padded width the kernel is compiled for (4, 8, 16 or 32), 0 if none.
extern "C" int cnf_k3_padded_dz(int dz) {
  if (dz < 1) return 0;
  if (dz <= 4) return 4;
  if (dz <= 8) return 8;
  if (dz <= 16) return 16;
  if (dz <= 32) return 32;
  return 0;
}

// Largest co-resident grid for a cooperative launch (0 if none).
extern "C" int cnf_k3_max_grid(int dz, int H, int block, int* out) {
  switch (cnf_k3_padded_dz(dz)) {
    case 4: return (int)max_grid<4>(H, block, out);
    case 8: return (int)max_grid<8>(H, block, out);
    case 16: return (int)max_grid<16>(H, block, out);
    case 32: return (int)max_grid<32>(H, block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// tab: a (kStages x kStages, row-major), b (kStages), btilde (kStages).
// Returns the launch's cudaError_t.
extern "C" int cnf_k3_test_solve(const float* w1, const float* b1, const float* w2,
                                 const float* b2, const float* z0, const float* dlogp0,
                                 const float* ts, float* zT, float* dlogpT, int* stats,
                                 float* dt_last, float* work, float* partials, int B, int dz,
                                 int H, int max_steps, float rtol, float atol, float beta1,
                                 float beta2, float inv_order, const float* tab, int grid,
                                 int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2;
  a.z0 = z0; a.dlogp0 = dlogp0; a.ts = ts;
  a.zT = zT; a.dlogpT = dlogpT; a.stats = stats; a.dt_last = dt_last;
  a.work = work; a.partials = partials;
  a.B = B; a.dz = dz; a.H = H; a.max_steps = max_steps;
  a.rtol = rtol; a.atol = atol; a.beta1 = beta1; a.beta2 = beta2; a.inv_order = inv_order;
  for (int i = 0; i < kStages; ++i) {
    for (int j = 0; j < kStages; ++j) a.tab.a[i][j] = tab[i * kStages + j];
    a.tab.b[i] = tab[kStages * kStages + i];
    a.tab.btilde[i] = tab[kStages * kStages + kStages + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (cnf_k3_padded_dz(dz)) {
    case 4: return (int)launch<4>(a, grid, block, s);
    case 8: return (int)launch<8>(a, grid, block, s);
    case 16: return (int)launch<16>(a, grid, block, s);
    case 32: return (int)launch<32>(a, grid, block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
