// K4 forward: the exact-trace TRAIN-mode forward solve of a CNF whose field is
// a 2-layer tanh MLP, the whole adaptive solve (any embedded explicit tableau,
// K9) in one cooperative launch.
//
// Replaces the TPU kernel continuousnf_tpu/ops/fused_solve.py::_run_solve_kernel
// (pl.pallas_call at :1043) built by _make_solve_kernel (:773-942) with the
// _stage_train_exact stage (:571-608) and the pm matrix of exact_stage_consts
// (:542-559).  What it computes, per attempted step: the RK stages of the
// state [z (B, dz) | -tr | ||f|| | ||J||_F] (three accumulator rows), where
// per sample, with dh = 1 - h^2 and dy = 1 - y^2,
//   h = tanh(z W1 + b1),  y = tanh(h W2 + b2)               (the field)
//   m[j, i] = sum_h W1[j, h] dh_h W2[h, i]                 (J_ji = m[j, i] dy_i)
//   tr = sum_i dy_i m[i, i],  fro^2 = sum_i dy_i^2 sum_j m[j, i]^2
//   rates: -tr,  ||y|| (norm_z),  sqrt(fro^2) (norm_j)      (safe norms)
// then ONE Hairer norm over all B * (dz + 3) elements, the PI controller,
// FSAL or the non-FSAL refresh and the max_steps cap: the loop of solve_common.cuh, shared with K3
// and K1; only the field differs.  The accumulators are seeded from the
// incoming state (the TPU kernel zeroes them, fused_solve.py:836-838, a
// fault that is not copied).
//
// What bounds it on the H100: latency, as for K1.  The stage is dz^2 H FMA per
// sample for m (12,288 at dz = 16, H = 48, about 4x K1's), which one thread
// per sample runs as dependent chains; plus one grid barrier per attempted
// step.  The design keeps registers small and needs no pm buffer: the rows of
// m are built one j at a time as a DZ-register vector, m[j, :] += (W1[j, h]
// dh_h) W2[h, :] over h, from the w1t and w2p rows already in shared memory
// (float4 broadcast loads), and folded into tr and the column sums of
// squares s_i as they come.  dh lives in the thread's shared-memory column
// (H floats at a stride of the block size: conflict-free), as K1 keeps h.
// The j loop is not unrolled (m's diagonal entry is taken by a select), which
// keeps the code and the register count small.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores (the
// step counts depend on the stage's rounding).
//
// The COND instance (K8 in the 2-layer kernels): _stage_train_exact with
// _zin (fused_solve.py:265) for a conditional 2-layer net whose W1 reads
// [z | ys]: each hidden pre-activation adds ys . wy[h] (W1's ys rows, (H, nc)
// in shared memory after the dh buffer; the sample's ys row in registers,
// two_layer_cond.cuh), while the rows of m read w1t, W1's z rows only, as pm does
// (exact_stage_consts over w1z, :542-559).  At cond_flagship (17 -> 48 -> 16,
// one ys column) that adds 48 FMA to the stage's 13.8 k a sample.  Its
// entries are cnf_k4c_max_grid and cnf_k4_cond_solve.

#include "solve_common.cuh"
#include "two_layer_cond.cuh"

namespace {

// The unroll factor of the solve loops over stored stages (solve_common.cuh),
// the fastest of 1, 2, 4 and 8 for this kernel on the H100 (PERF.md, PR 6).
constexpr int kStageUnroll = 1;

using cnf::axpy4;
using cnf::CondRows;
using cnf::dot4;
using cnf::FwdArgs;
using cnf::kMaxBlock;
using cnf::kRedFloats;
using cnf::safe_norm_sq;

// The exact TRAIN field of one sample.  Columns i >= dz of the padded
// weights are zero, so padded entries add nothing to y, m, tr or fro^2.
// COND: the pre-activation of h adds ys . wy[h].
template <int DZ, bool COND>
struct ExactField : CondRows<COND> {
  const float* w1t;  // (H, DZ): w1t[h][j] = w1[j][h]
  const float* b1;   // (H)
  const float* w2p;  // (H, DZ): w2p[h][i] = w2[h][i]
  const float* b2p;  // (DZ)
  float* dhcol;      // this thread's dh column: dhcol[h * stride]
  int H, dz, stride, norm_z, norm_j;

  __device__ __forceinline__ void operator()([[maybe_unused]] int smp, const float (&z)[DZ], float (&ky)[DZ],
                                             float (&kr)[3]) const {
    float pre[DZ];
#pragma unroll
    for (int k = 0; k < DZ; ++k) pre[k] = b2p[k];
    [[maybe_unused]] cnf::CondRegs<COND> yv;
    if constexpr (COND) this->load(smp, yv);
    for (int h = 0; h < H; ++h) {
      float a1 = dot4<DZ>(z, w1t + h * DZ) + b1[h];
      if constexpr (COND) a1 = this->add(a1, h, yv, smp);
      const float a = tanhf(a1);
      dhcol[h * stride] = 1.f - a * a;
      axpy4<DZ>(pre, a, w2p + h * DZ);
    }
    float dy[DZ], ysq = 0.f;
#pragma unroll
    for (int k = 0; k < DZ; ++k) {
      const float y = tanhf(pre[k]);
      ky[k] = y;
      ysq = fmaf(y, y, ysq);
      dy[k] = 1.f - y * y;
    }
    // Rows of m, one at a time: tr += dy_j m[j, j], s[i] += m[j, i]^2.  The
    // diagonal entry is picked by a select, so m stays in registers without
    // unrolling the j loop.
    float s[DZ], tr = 0.f;
#pragma unroll
    for (int i = 0; i < DZ; ++i) s[i] = 0.f;
#pragma unroll 1
    for (int j = 0; j < dz; ++j) {
      float m[DZ];
#pragma unroll
      for (int i = 0; i < DZ; ++i) m[i] = 0.f;
      for (int h = 0; h < H; ++h) axpy4<DZ>(m, w1t[h * DZ + j] * dhcol[h * stride], w2p + h * DZ);
#pragma unroll
      for (int i = 0; i < DZ; ++i) {
        if (i == j) tr = fmaf(dy[i], m[i], tr);
        s[i] = fmaf(m[i], m[i], s[i]);
      }
    }
    float fro2 = 0.f;
#pragma unroll
    for (int i = 0; i < DZ; ++i) fro2 = fmaf(dy[i] * dy[i], s[i], fro2);
    kr[0] = -tr;
    kr[1] = norm_z ? safe_norm_sq(ysq) : 0.f;
    kr[2] = norm_j ? safe_norm_sq(fro2) : 0.f;
  }
};

template <int DZ>
__global__ void __launch_bounds__(kMaxBlock) k4_exact_solve(const FwdArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int H = p.H, dz = p.dz;
  float* w1t = smem;               // (H, DZ)
  float* w2p = w1t + H * DZ;       // (H, DZ)
  float* b2p = w2p + H * DZ;       // (DZ)
  float* b1 = b2p + DZ;            // (H)
  float* red = b1 + H;             // kRedFloats
  float* dhbuf = red + kRedFloats; // (H, blockDim.x)
  cnf::load_weights<DZ>(p.w1, p.b1, p.w2, p.b2, dz, H, w1t, w2p, b2p, b1);
  __syncthreads();

  const ExactField<DZ, false> field{{}, w1t, b1, w2p, b2p, dhbuf + threadIdx.x,
                                    H, dz, (int)blockDim.x, p.norm_z, p.norm_j};
  cnf::forward_solve<DZ, 3, kStageUnroll>(p, field, red);
}

// The shared memory of an instance with nc ys rows (0: unconditional).
template <int DZ>
size_t smem_bytes(int H, int block, int nc = 0) {
  return sizeof(float) * (cnf::weight_floats<DZ>(H) + kRedFloats + (size_t)H * block + (size_t)H * nc);
}

// The COND instance's arguments: the unconditional instance's and the
// conditioning ys (B, nc), nc >= 1.
struct CondArgs {
  FwdArgs f;
  const float* ys;
  int nc;
};

// The COND instance: k4_exact_solve's layout with wy (H, nc) after the dh
// buffer; w1t holds W1's z rows (load_weights reads the first dz rows of
// the (dz + nc, H) matrix).
template <int DZ>
__global__ void __launch_bounds__(kMaxBlock) k4_exact_cond_solve(const __grid_constant__ CondArgs ca) {
  extern __shared__ __align__(16) float smem[];
  const FwdArgs& p = ca.f;
  const int H = p.H, dz = p.dz, nc = ca.nc;
  float* w1t = smem;                      // (H, DZ)
  float* w2p = w1t + H * DZ;              // (H, DZ)
  float* b2p = w2p + H * DZ;              // (DZ)
  float* b1 = b2p + DZ;                   // (H)
  float* red = b1 + H;                    // kRedFloats
  float* dhbuf = red + kRedFloats;        // (H, blockDim.x)
  float* wy = dhbuf + H * blockDim.x;     // (H, nc)
  cnf::load_weights<DZ>(p.w1, p.b1, p.w2, p.b2, dz, H, w1t, w2p, b2p, b1);
  for (int idx = threadIdx.x; idx < H * nc; idx += blockDim.x) {
    const int h = idx / nc, c = idx % nc;
    wy[idx] = p.w1[(size_t)(dz + c) * H + h];
  }
  __syncthreads();

  const ExactField<DZ, true> field{{ca.ys, wy, nc}, w1t, b1, w2p, b2p, dhbuf + threadIdx.x,
                                   H, dz, (int)blockDim.x, p.norm_z, p.norm_j};
  cnf::forward_solve<DZ, 3, kStageUnroll>(p, field, red);
}

}  // namespace

// Largest co-resident grid for a cooperative launch (0 if none).
extern "C" int cnf_k4_max_grid(int dz, int H, int block, int* out) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_max_grid(k4_exact_solve<4>, smem_bytes<4>(H, block), block, out);
    case 8: return (int)cnf::coop_max_grid(k4_exact_solve<8>, smem_bytes<8>(H, block), block, out);
    case 16: return (int)cnf::coop_max_grid(k4_exact_solve<16>, smem_bytes<16>(H, block), block, out);
    case 32: return (int)cnf::coop_max_grid(k4_exact_solve<32>, smem_bytes<32>(H, block), block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// acc0/accT: (3, B), rows [dlogp | reg_e | reg_n].  dt_last: (2), the
// next step size and the last step taken.  tab: kTableauFloats floats
// (read_tableau).  Returns the launch's cudaError_t.
extern "C" int cnf_k4_exact_solve(const float* w1, const float* b1, const float* w2,
                                  const float* b2, const float* z0, const float* acc0,
                                  const float* ts, float* zT, float* accT, int* stats,
                                  float* dt_last, float* work, float* partials, int B, int dz,
                                  int H, int max_steps, int norm_z, int norm_j, float rtol,
                                  float atol, float beta1, float beta2, float inv_order,
                                  const float* tab, int grid, int block, void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  cnf::set_fwd_args(&a, nullptr, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, dz,
                    max_steps, norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2; a.H = H;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_launch(k4_exact_solve<4>, a, grid, block, smem_bytes<4>(H, block), s);
    case 8: return (int)cnf::coop_launch(k4_exact_solve<8>, a, grid, block, smem_bytes<8>(H, block), s);
    case 16: return (int)cnf::coop_launch(k4_exact_solve<16>, a, grid, block, smem_bytes<16>(H, block), s);
    case 32: return (int)cnf::coop_launch(k4_exact_solve<32>, a, grid, block, smem_bytes<32>(H, block), s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The COND instance (K8): largest co-resident grid with nc ys rows.
extern "C" int cnf_k4c_max_grid(int dz, int H, int nc, int block, int* out) {
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_max_grid(k4_exact_cond_solve<4>, smem_bytes<4>(H, block, nc), block, out);
    case 8: return (int)cnf::coop_max_grid(k4_exact_cond_solve<8>, smem_bytes<8>(H, block, nc), block, out);
    case 16: return (int)cnf::coop_max_grid(k4_exact_cond_solve<16>, smem_bytes<16>(H, block, nc), block, out);
    case 32: return (int)cnf::coop_max_grid(k4_exact_cond_solve<32>, smem_bytes<32>(H, block, nc), block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The COND instance (K8): as cnf_k4_exact_solve for a conditional net, w1
// (dz + nc, H) and ys (B, nc) (device), nc >= 1.
extern "C" int cnf_k4_cond_solve(const float* w1, const float* b1, const float* w2, const float* b2,
                                 const float* ys, const float* z0, const float* acc0, const float* ts, float* zT,
                                 float* accT, int* stats, float* dt_last, float* work, float* partials, int B,
                                 int dz, int H, int nc, int max_steps, int norm_z, int norm_j, float rtol, float atol,
                                 float beta1, float beta2, float inv_order, const float* tab, int grid, int block,
                                 void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1 || nc < 1 || ys == nullptr)
    return (int)cudaErrorInvalidValue;
  CondArgs ca = {};
  FwdArgs& a = ca.f;
  cnf::set_fwd_args(&a, nullptr, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, dz,
                    max_steps, norm_z, norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2; a.H = H;
  ca.ys = ys;
  ca.nc = nc;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cnf::padded_dz(dz)) {
    case 4: return (int)cnf::coop_launch(k4_exact_cond_solve<4>, ca, grid, block, smem_bytes<4>(H, block, nc), s);
    case 8: return (int)cnf::coop_launch(k4_exact_cond_solve<8>, ca, grid, block, smem_bytes<8>(H, block, nc), s);
    case 16: return (int)cnf::coop_launch(k4_exact_cond_solve<16>, ca, grid, block, smem_bytes<16>(H, block, nc), s);
    case 32: return (int)cnf::coop_launch(k4_exact_cond_solve<32>, ca, grid, block, smem_bytes<32>(H, block, nc), s);
    default: return (int)cudaErrorInvalidValue;
  }
}
