// K1: the TRAIN-mode forward solve of a CNF whose field is a 2-layer tanh MLP
// with Hutchinson probes, the whole adaptive solve (any embedded explicit
// tableau, K9) in one cooperative launch.  Two instances: one reverse-mode
// probe (below), and the probe instance (K6, at the end) for K probes,
// reverse or forward mode.
//
// Replaces the TPU kernel continuousnf_tpu/ops/fused_solve.py::_run_solve_kernel
// (pl.pallas_call at :1043) built by _make_solve_kernel (:773-942) with the
// _stage_train stage (:333-369; _probe_pullback :291, _safe_col_norm :155).
// What it computes, per attempted step: the RK stages of the state
// [z (B, dz) | -tr | ||f|| | ||eps^T J||] (three accumulator rows), where per
// sample
//   h = tanh(z W1 + b1),  y = tanh(h W2 + b2)               (the field)
//   v1 = eps (1 - y^2),  u1 = W2 v1,  v0 = u1 (1 - h^2),  eJ = W1 v0
//   rates: -<eJ, eps>,  ||y|| (norm_z),  ||eJ|| (norm_j)   (safe norms)
// then ONE Hairer norm over all B * (dz + 3) elements, the PI controller,
// FSAL or the non-FSAL refresh and the max_steps cap (the loop of solve_common.cuh, shared with K3).
// The accumulators are seeded from the incoming state; the TPU kernel starts
// them at zero (fused_solve.py:836-838), a fault that is not copied.
//
// What bounds it on the H100: latency, as for K3.  A stage is about
// 4 * dz * H FMA per sample (3 k at dz = 16, H = 48), so a whole stage at
// B = 4096 is microseconds of one SM's work; the time goes to each thread's
// dependent FMA chains and to one grid barrier per attempted step.  The
// design is K3's: one thread per sample, weights in shared memory read with
// 16-byte broadcast loads, state and stage registers in a (row, B) global
// scratch.  The hidden activations h, which the pullback needs after the
// forward pass, go to a per-thread column of shared memory (H floats at a
// stride of the block size: conflict-free) instead of registers.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The probe instance (K6): _stage_train with k_probes = K and jvp (the probe
// loop :350-364, _probe_pushforward :309-330): the forward pass once, then
// per probe, from the (K, B, dz) probes, eps^T J by the pullback above or
// J eps by the pushforward
//   u0 = eps W1,  t1 = u0 (1 - h^2),  Je = (t1 W2) (1 - y^2),
// which reads the same w1t and w2p rows as the forward pass and needs no
// hidden column of its own; the trace and probe-norm terms are summed and
// divided by K.  K and the direction are run-time values: one instance runs
// every probe count and both directions, and the one-probe instance stays
// as it was.

#include "solve_common.cuh"

namespace {

// The unroll factor of the solve loops over stored stages (solve_common.cuh),
// the fastest of 1, 2, 4 and 8 for this kernel on the H100 (PERF.md, PR 6).
constexpr int kStageUnroll = 1;

using cnf::FwdArgs;
using cnf::kMaxBlock;
using cnf::kRedFloats;
using cnf::safe_norm_sq;

// The TRAIN field of one sample with its probe.  Columns i >= dz of the
// padded weights are zero and the probe is zero there, so padded entries add
// nothing to y, eJ, the trace or the norms.
template <int DZ>
struct TrainField {
  const float* w1t;  // (H, DZ): w1t[j][i] = w1[i][j]
  const float* b1;   // (H)
  const float* w2p;  // (H, DZ): w2p[j][k] = w2[j][k]
  const float* b2p;  // (DZ)
  const float* eps;  // (B, dz)
  float* hcol;       // this thread's h column: hcol[j * hstride]
  int H, dz, hstride, norm_z, norm_j;

  __device__ __forceinline__ void operator()(int s, const float (&z)[DZ], float (&ky)[DZ],
                                             float (&kr)[3]) const {
    float pre[DZ];
#pragma unroll
    for (int k = 0; k < DZ; ++k) pre[k] = b2p[k];
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
      hcol[j * hstride] = h;
      const float4* w2j = reinterpret_cast<const float4*>(w2p + j * DZ);
#pragma unroll
      for (int q = 0; q < DZ / 4; ++q) {
        const float4 w = w2j[q];
        pre[4 * q + 0] = fmaf(h, w.x, pre[4 * q + 0]);
        pre[4 * q + 1] = fmaf(h, w.y, pre[4 * q + 1]);
        pre[4 * q + 2] = fmaf(h, w.z, pre[4 * q + 2]);
        pre[4 * q + 3] = fmaf(h, w.w, pre[4 * q + 3]);
      }
    }
    // y and the probe gated by the output layer's tanh'.
    float e[DZ], v1[DZ], ysq = 0.f;
#pragma unroll
    for (int k = 0; k < DZ; ++k) {
      const float y = tanhf(pre[k]);
      ky[k] = y;
      ysq = fmaf(y, y, ysq);
      e[k] = k < dz ? eps[(size_t)s * dz + k] : 0.f;
      v1[k] = e[k] * (1.f - y * y);
    }
    // The pullback eJ = eps^T J through both layers.
    float eJ[DZ];
#pragma unroll
    for (int i = 0; i < DZ; ++i) eJ[i] = 0.f;
    for (int j = 0; j < H; ++j) {
      const float4* w2j = reinterpret_cast<const float4*>(w2p + j * DZ);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < DZ / 4; ++q) {
        const float4 w = w2j[q];
        a0 = fmaf(v1[4 * q + 0], w.x, a0);
        a1 = fmaf(v1[4 * q + 1], w.y, a1);
        a2 = fmaf(v1[4 * q + 2], w.z, a2);
        a3 = fmaf(v1[4 * q + 3], w.w, a3);
      }
      const float h = hcol[j * hstride];
      const float v0 = ((a0 + a1) + (a2 + a3)) * (1.f - h * h);
      const float4* w1j = reinterpret_cast<const float4*>(w1t + j * DZ);
#pragma unroll
      for (int q = 0; q < DZ / 4; ++q) {
        const float4 w = w1j[q];
        eJ[4 * q + 0] = fmaf(w.x, v0, eJ[4 * q + 0]);
        eJ[4 * q + 1] = fmaf(w.y, v0, eJ[4 * q + 1]);
        eJ[4 * q + 2] = fmaf(w.z, v0, eJ[4 * q + 2]);
        eJ[4 * q + 3] = fmaf(w.w, v0, eJ[4 * q + 3]);
      }
    }
    float tr = 0.f, nsq = 0.f;
#pragma unroll
    for (int i = 0; i < DZ; ++i) {
      tr = fmaf(eJ[i], e[i], tr);
      nsq = fmaf(eJ[i], eJ[i], nsq);
    }
    kr[0] = -tr;
    kr[1] = norm_z ? safe_norm_sq(ysq) : 0.f;
    kr[2] = norm_j ? safe_norm_sq(nsq) : 0.f;
  }
};

// The probe instance's field (K6): K probes of sample s at eps[k][s],
// reverse (eps^T J) or, `jvp`, forward mode (J eps).
template <int DZ>
struct ProbeField {
  const float* w1t;  // (H, DZ): w1t[j][i] = w1[i][j]
  const float* b1;   // (H)
  const float* w2p;  // (H, DZ): w2p[j][k] = w2[j][k]
  const float* b2p;  // (DZ)
  const float* eps;  // (K, B, dz)
  float* hcol;       // this thread's h column: hcol[j * hstride]
  int H, dz, hstride, B, K, jvp, norm_z, norm_j;

  __device__ __forceinline__ void operator()(int s, const float (&z)[DZ], float (&ky)[DZ],
                                             float (&kr)[3]) const {
    float pre[DZ];
#pragma unroll
    for (int k = 0; k < DZ; ++k) pre[k] = b2p[k];
    for (int j = 0; j < H; ++j) {
      const float h = tanhf(cnf::dot4<DZ>(z, w1t + j * DZ) + b1[j]);
      hcol[j * hstride] = h;
      cnf::axpy4<DZ>(pre, h, w2p + j * DZ);
    }
    float gy[DZ], ysq = 0.f;
#pragma unroll
    for (int k = 0; k < DZ; ++k) {
      const float y = tanhf(pre[k]);
      ky[k] = y;
      ysq = fmaf(y, y, ysq);
      gy[k] = 1.f - y * y;
    }
    float tr = 0.f, nsum = 0.f;
    for (int pk = 0; pk < K; ++pk) {
      const float* ek = eps + ((size_t)pk * B + s) * dz;
      float e[DZ], eJ[DZ];
#pragma unroll
      for (int k = 0; k < DZ; ++k) {
        e[k] = k < dz ? ek[k] : 0.f;
        eJ[k] = 0.f;
      }
      if (jvp) {
        // J eps: t1_j = (eps . W1[:, j]) (1 - h_j^2), Je = (t1 W2) (1 - y^2).
        for (int j = 0; j < H; ++j) {
          const float h = hcol[j * hstride];
          cnf::axpy4<DZ>(eJ, cnf::dot4<DZ>(e, w1t + j * DZ) * (1.f - h * h), w2p + j * DZ);
        }
#pragma unroll
        for (int k = 0; k < DZ; ++k) eJ[k] *= gy[k];
      } else {
        // eps^T J: v1 = eps (1 - y^2), v0_j = (W2[j, :] . v1) (1 - h_j^2), eJ = W1 v0.
        float v1[DZ];
#pragma unroll
        for (int k = 0; k < DZ; ++k) v1[k] = e[k] * gy[k];
        for (int j = 0; j < H; ++j) {
          const float h = hcol[j * hstride];
          cnf::axpy4<DZ>(eJ, cnf::dot4<DZ>(v1, w2p + j * DZ) * (1.f - h * h), w1t + j * DZ);
        }
      }
      float trk = 0.f, nsq = 0.f;
#pragma unroll
      for (int i = 0; i < DZ; ++i) {
        trk = fmaf(eJ[i], e[i], trk);
        nsq = fmaf(eJ[i], eJ[i], nsq);
      }
      tr += trk;
      nsum += safe_norm_sq(nsq);
    }
    kr[0] = -(tr / K);
    kr[1] = norm_z ? safe_norm_sq(ysq) : 0.f;
    kr[2] = norm_j ? nsum / K : 0.f;
  }
};

template <int DZ>
__global__ void __launch_bounds__(kMaxBlock) k1_train_solve(const FwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, dz = p.dz;
  float* w1t = smem;          // (H, DZ)
  float* w2p = w1t + H * DZ;  // (H, DZ)
  float* b2p = w2p + H * DZ;  // (DZ)
  float* b1 = b2p + DZ;       // (H)
  float* red = b1 + H;        // kRedFloats
  float* hbuf = red + kRedFloats;  // (H, blockDim.x)

  cnf::load_weights<DZ>(p.w1, p.b1, p.w2, p.b2, dz, H, w1t, w2p, b2p, b1);
  __syncthreads();

  const TrainField<DZ> field{w1t, b1, w2p, b2p, p.eps, hbuf + threadIdx.x,
                             H, dz, (int)blockDim.x, p.norm_z, p.norm_j};
  cnf::forward_solve<DZ, 3, kStageUnroll>(p, field, red);
}

// The probe instance's kernel (K6).
struct ProbeArgs {
  FwdArgs f;
  int K, jvp;
};

template <int DZ>
__global__ void __launch_bounds__(kMaxBlock) k1_probe_solve(const ProbeArgs a) {
  extern __shared__ __align__(16) float smem[];
  const FwdArgs& p = a.f;
  const int H = p.H, dz = p.dz;
  float* w1t = smem;          // (H, DZ)
  float* w2p = w1t + H * DZ;  // (H, DZ)
  float* b2p = w2p + H * DZ;  // (DZ)
  float* b1 = b2p + DZ;       // (H)
  float* red = b1 + H;        // kRedFloats
  float* hbuf = red + kRedFloats;  // (H, blockDim.x)

  cnf::load_weights<DZ>(p.w1, p.b1, p.w2, p.b2, dz, H, w1t, w2p, b2p, b1);
  __syncthreads();

  const ProbeField<DZ> field{w1t, b1, w2p, b2p, p.eps, hbuf + threadIdx.x, H, dz, (int)blockDim.x, p.B,
                             a.K, a.jvp, p.norm_z, p.norm_j};
  cnf::forward_solve<DZ, 3, kStageUnroll>(p, field, red);
}

template <int DZ>
size_t smem_bytes(int H, int block) {
  return sizeof(float) * (2 * (size_t)H * DZ + DZ + H + kRedFloats + (size_t)H * block);
}

}  // namespace

// Largest co-resident grid for a cooperative launch (0 if none).
extern "C" int cnf_k1_max_grid(int dz, int H, int block, int* out) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_max_grid(k1_train_solve<4>, smem_bytes<4>(H, block), block, out);
    case 8: return (int)cnf::coop_max_grid(k1_train_solve<8>, smem_bytes<8>(H, block), block, out);
    case 16: return (int)cnf::coop_max_grid(k1_train_solve<16>, smem_bytes<16>(H, block), block, out);
    case 32: return (int)cnf::coop_max_grid(k1_train_solve<32>, smem_bytes<32>(H, block), block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// acc0/accT: (3, B), rows [dlogp | reg_e | reg_n].  dt_last: (2), the
// next step size and the last step taken.  tab: kTableauFloats floats
// (read_tableau).  Returns the launch's cudaError_t.
extern "C" int cnf_k1_train_solve(const float* w1, const float* b1, const float* w2,
                                  const float* b2, const float* eps, const float* z0,
                                  const float* acc0, const float* ts, float* zT, float* accT,
                                  int* stats, float* dt_last, float* work, float* partials, int B,
                                  int dz, int H, int max_steps, int norm_z, int norm_j, float rtol,
                                  float atol, float beta1, float beta2, float inv_order,
                                  const float* tab, int grid, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  cnf::set_fwd_args(&a, eps, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, dz,
                    max_steps, norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2; a.H = H;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_launch(k1_train_solve<4>, a, grid, block, smem_bytes<4>(H, block), s);
    case 8: return (int)cnf::coop_launch(k1_train_solve<8>, a, grid, block, smem_bytes<8>(H, block), s);
    case 16: return (int)cnf::coop_launch(k1_train_solve<16>, a, grid, block, smem_bytes<16>(H, block), s);
    case 32: return (int)cnf::coop_launch(k1_train_solve<32>, a, grid, block, smem_bytes<32>(H, block), s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The probe instance (K6): its largest co-resident grid, and the solve as
// cnf_k1_train_solve's with eps (K, B, dz), K >= 1 probes, reverse mode or
// (jvp) forward mode.
extern "C" int cnf_k1p_max_grid(int dz, int H, int block, int* out) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_max_grid(k1_probe_solve<4>, smem_bytes<4>(H, block), block, out);
    case 8: return (int)cnf::coop_max_grid(k1_probe_solve<8>, smem_bytes<8>(H, block), block, out);
    case 16: return (int)cnf::coop_max_grid(k1_probe_solve<16>, smem_bytes<16>(H, block), block, out);
    case 32: return (int)cnf::coop_max_grid(k1_probe_solve<32>, smem_bytes<32>(H, block), block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int cnf_k1_probe_solve(const float* w1, const float* b1, const float* w2,
                                  const float* b2, const float* eps, const float* z0,
                                  const float* acc0, const float* ts, float* zT, float* accT,
                                  int* stats, float* dt_last, float* work, float* partials, int B,
                                  int dz, int H, int max_steps, int norm_z, int norm_j, int K, int jvp,
                                  float rtol, float atol, float beta1, float beta2, float inv_order,
                                  const float* tab, int grid, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  ProbeArgs a;
  cnf::set_fwd_args(&a.f, eps, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, dz,
                    max_steps, norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.f.w1 = w1; a.f.b1 = b1; a.f.w2 = w2; a.f.b2 = b2; a.f.H = H;
  a.K = K;
  a.jvp = jvp;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_launch(k1_probe_solve<4>, a, grid, block, smem_bytes<4>(H, block), s);
    case 8: return (int)cnf::coop_launch(k1_probe_solve<8>, a, grid, block, smem_bytes<8>(H, block), s);
    case 16: return (int)cnf::coop_launch(k1_probe_solve<16>, a, grid, block, smem_bytes<16>(H, block), s);
    case 32: return (int)cnf::coop_launch(k1_probe_solve<32>, a, grid, block, smem_bytes<32>(H, block), s);
    default: return (int)cudaErrorInvalidValue;
  }
}
