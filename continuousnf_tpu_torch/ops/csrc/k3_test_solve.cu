// K3: the TEST-mode forward solve of a CNF whose field is a 2-layer tanh MLP,
// the whole adaptive solve (any embedded explicit tableau, K9) in one
// cooperative launch.
//
// Replaces the TPU kernel continuousnf_tpu/ops/fused_solve.py::_run_solve_kernel
// (pl.pallas_call at :1043) built by _make_solve_kernel (:773-942) with the
// _stage_test stage (:484-503).  What it computes, per attempted step:
//   * the RK stages of the state [z (B, dz) | dlogp (B)], where the field
//     is y = tanh(tanh(z W1 + b1) W2 + b2) and the dlogp rate is
//     -tr J = -sum_i dy_i (M dh)_i, M[i, h] = W1[i, h] W2[h, i];
//   * the embedded error and ONE Hairer norm over all B * (dz + 1) elements
//     (the step control is batch-global, as in ode/solve.py::_attempt_step);
//   * a global finite flag over the proposed state;
//   * the PI controller, FSAL or the non-FSAL refresh, and the max_steps cap.
// The accumulator row is seeded from the incoming dlogp (the TPU kernel
// starts it at zero, fused_solve.py:836-838; that fault is not copied).
// The solver loop, the controller and the grid reduction live in
// solve_common.cuh, shared with K1 (k1_train_solve.cu).
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
//
// The COND instance (K8 in the 2-layer kernels): the same _stage_test of a
// conditional 2-layer net, whose W1 reads [z | ys] (_zin, fused_solve.py:265):
// W1's ys rows wy (H, nc) sit in shared memory beside the z rows, and each
// hidden pre-activation adds ys . wy[j] from the sample's ys row, loaded
// into registers once a field evaluation (two_layer_cond.cuh).  M and the trace read
// W1's z rows only (w1z, :497), as the unconditional instance's M does.  At
// cond_flagship (17 -> 48 -> 16, one ys column) that adds 48 FMA to the
// stage's 2.3 k a sample.  Its entries are cnf_k3c_max_grid and
// cnf_k3_cond_solve.

#include "solve_common.cuh"
#include "two_layer_cond.cuh"

namespace {

// The unroll factor of the solve loops over stored stages (solve_common.cuh),
// the fastest of 1, 2, 4 and 8 for this kernel on the H100 (PERF.md, PR 6).
constexpr int kStageUnroll = 1;

using cnf::CondRows;
using cnf::FwdArgs;
using cnf::kMaxBlock;
using cnf::kRedFloats;

// The TEST field of one sample: ky = y, kr = -tr J.  Columns i >= dz of the
// padded weights are zero, so padded inputs contribute nothing and padded
// outputs (y = tanh(0) = 0, M dh = 0) add nothing to the trace.  COND: the
// pre-activation of h adds ys . wy[j].
template <int DZ, bool COND>
struct TestField : CondRows<COND> {
  const float* w1t;  // (H, DZ): w1t[j][i] = w1[i][j], the z rows
  const float* b1;   // (H)
  const float* w2p;  // (H, DZ): w2p[j][k] = w2[j][k]
  const float* b2p;  // (DZ)
  const float* mt;   // (H, DZ): mt[j][i] = w1[i][j] * w2[j][i]
  int H;

  __device__ __forceinline__ void operator()([[maybe_unused]] int smp, const float (&z)[DZ], float (&ky)[DZ],
                                             float (&kr)[1]) const {
    float pre[DZ], mdh[DZ];
#pragma unroll
    for (int k = 0; k < DZ; ++k) {
      pre[k] = b2p[k];
      mdh[k] = 0.f;
    }
    [[maybe_unused]] cnf::CondRegs<COND> yv;
    if constexpr (COND) this->load(smp, yv);
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
      float pre1 = ((a0 + a1) + (a2 + a3)) + b1[j];
      if constexpr (COND) pre1 = this->add(pre1, j, yv, smp);
      const float h = tanhf(pre1);
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
    kr[0] = -tr;
  }
};

template <int DZ>
__global__ void __launch_bounds__(kMaxBlock) k3_test_solve(const FwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, dz = p.dz;
  float* w1t = smem;          // (H, DZ)
  float* w2p = w1t + H * DZ;  // (H, DZ)
  float* mt = w2p + H * DZ;   // (H, DZ)
  float* b2p = mt + H * DZ;   // (DZ)
  float* b1 = b2p + DZ;       // (H)
  float* red = b1 + H;        // kRedFloats

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

  const TestField<DZ, false> field{{}, w1t, b1, w2p, b2p, mt, H};
  cnf::forward_solve<DZ, 1, kStageUnroll>(p, field, red);
}

// The shared memory of an instance with nc ys rows (0: unconditional).
template <int DZ>
size_t smem_bytes(int H, int nc = 0) {
  return sizeof(float) * (3 * (size_t)H * DZ + DZ + H + kRedFloats + (size_t)H * nc);
}

// The COND instance's arguments: the unconditional instance's and the
// conditioning ys (B, nc), nc >= 1.
struct CondArgs {
  FwdArgs f;
  const float* ys;
  int nc;
};

// The COND instance: k3_test_solve's layout with wy (H, nc) after the
// reduction slots; w1t holds W1's z rows, and M is built from them.
template <int DZ>
__global__ void __launch_bounds__(kMaxBlock) k3_test_cond_solve(const __grid_constant__ CondArgs ca) {
  extern __shared__ __align__(16) float smem[];
  const FwdArgs& p = ca.f;
  const int H = p.H, dz = p.dz, nc = ca.nc;
  float* w1t = smem;             // (H, DZ)
  float* w2p = w1t + H * DZ;     // (H, DZ)
  float* mt = w2p + H * DZ;      // (H, DZ)
  float* b2p = mt + H * DZ;      // (DZ)
  float* b1 = b2p + DZ;          // (H)
  float* red = b1 + H;           // kRedFloats
  float* wy = red + kRedFloats;  // (H, nc)

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
  for (int idx = threadIdx.x; idx < H * nc; idx += blockDim.x) {
    const int j = idx / nc, c = idx % nc;
    wy[idx] = p.w1[(size_t)(dz + c) * H + j];
  }
  __syncthreads();

  const TestField<DZ, true> field{{ca.ys, wy, nc}, w1t, b1, w2p, b2p, mt, H};
  cnf::forward_solve<DZ, 1, kStageUnroll>(p, field, red);
}

}  // namespace

// The padded width the kernel is compiled for (4, 8, 16 or 32), 0 if none.
extern "C" int cnf_k3_padded_dz(int dz) { return cnf::padded_dz(dz); }

// Largest co-resident grid for a cooperative launch (0 if none).
extern "C" int cnf_k3_max_grid(int dz, int H, int block, int* out) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_max_grid(k3_test_solve<4>, smem_bytes<4>(H), block, out);
    case 8: return (int)cnf::coop_max_grid(k3_test_solve<8>, smem_bytes<8>(H), block, out);
    case 16: return (int)cnf::coop_max_grid(k3_test_solve<16>, smem_bytes<16>(H), block, out);
    case 32: return (int)cnf::coop_max_grid(k3_test_solve<32>, smem_bytes<32>(H), block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dt_last: (2), the next step size and the last step taken.  tab:
// kTableauFloats floats (read_tableau).
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
  FwdArgs a;
  cnf::set_fwd_args(&a, nullptr, z0, dlogp0, ts, zT, dlogpT, stats, dt_last, work, partials, B, dz,
                    max_steps, 0, 0, rtol, atol, beta1, beta2, inv_order, tab);
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2; a.H = H;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_launch(k3_test_solve<4>, a, grid, block, smem_bytes<4>(H), s);
    case 8: return (int)cnf::coop_launch(k3_test_solve<8>, a, grid, block, smem_bytes<8>(H), s);
    case 16: return (int)cnf::coop_launch(k3_test_solve<16>, a, grid, block, smem_bytes<16>(H), s);
    case 32: return (int)cnf::coop_launch(k3_test_solve<32>, a, grid, block, smem_bytes<32>(H), s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The COND instance (K8): largest co-resident grid with nc ys rows.
extern "C" int cnf_k3c_max_grid(int dz, int H, int nc, int block, int* out) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_max_grid(k3_test_cond_solve<4>, smem_bytes<4>(H, nc), block, out);
    case 8: return (int)cnf::coop_max_grid(k3_test_cond_solve<8>, smem_bytes<8>(H, nc), block, out);
    case 16: return (int)cnf::coop_max_grid(k3_test_cond_solve<16>, smem_bytes<16>(H, nc), block, out);
    case 32: return (int)cnf::coop_max_grid(k3_test_cond_solve<32>, smem_bytes<32>(H, nc), block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The COND instance (K8): as cnf_k3_test_solve for a conditional net, w1
// (dz + nc, H) and ys (B, nc) (device), nc >= 1.
extern "C" int cnf_k3_cond_solve(const float* w1, const float* b1, const float* w2, const float* b2,
                                 const float* ys, const float* z0, const float* dlogp0, const float* ts, float* zT,
                                 float* dlogpT, int* stats, float* dt_last, float* work, float* partials, int B,
                                 int dz, int H, int nc, int max_steps, float rtol, float atol, float beta1,
                                 float beta2, float inv_order, const float* tab, int grid, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1 || nc < 1 || ys == nullptr)
    return (int)cudaErrorInvalidValue;
  CondArgs ca = {};
  FwdArgs& a = ca.f;
  cnf::set_fwd_args(&a, nullptr, z0, dlogp0, ts, zT, dlogpT, stats, dt_last, work, partials, B, dz,
                    max_steps, 0, 0, rtol, atol, beta1, beta2, inv_order, tab);
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2; a.H = H;
  ca.ys = ys;
  ca.nc = nc;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_launch(k3_test_cond_solve<4>, ca, grid, block, smem_bytes<4>(H, nc), s);
    case 8: return (int)cnf::coop_launch(k3_test_cond_solve<8>, ca, grid, block, smem_bytes<8>(H, nc), s);
    case 16: return (int)cnf::coop_launch(k3_test_cond_solve<16>, ca, grid, block, smem_bytes<16>(H, nc), s);
    case 32: return (int)cnf::coop_launch(k3_test_cond_solve<32>, ca, grid, block, smem_bytes<32>(H, nc), s);
    default: return (int)cudaErrorInvalidValue;
  }
}
