// bf16 K1: K1's TRAIN-mode forward solve (k1_train_solve.cu) with the stage
// matmuls on the tensor cores in bf16, for a CNF whose field is an
// unconditional 2-layer tanh MLP of state width up to 32 with one
// Hutchinson VJP probe: the whole adaptive solve of [z | dlogp | reg_e |
// reg_n] (any embedded explicit tableau, K9) in one cooperative launch.
//
// Replaces the TPU kernel continuousnf_tpu/ops/fused_solve.py::_run_solve_kernel
// (pl.pallas_call at :1043) built by _make_solve_kernel (:773-942) with the
// _stage_train stage (:333-369, K = 1, VJP) under ComputeMode.bf16
// (:1464-1465): the forward chain _chain_fwd (:272-288) as bf16 K3's, and
// the probe pullback _probe_pullback (:291-306) with v1 = eps (1 - y^2)
// formed in f32 and then rounded,
//   u1 = bf16(v1) bf16(W2)^T, v0 = u1 (1 - h^2), eJ = bf16(v0) bf16(W1)^T;
// the rates [-sum eJ eps, ||y||, ||eJ||] in f32.  The plain twin is
// fused_solve.py::solve_train_plain(bf16=True).
//
// Design: forward_solve_tiles with NACC = 3, as bf16 K3 (k3_bf16_solve.cu):
// each warp takes its 32 rows of the tile as two m16 tiles; four products a
// stage, all mma.sync m16n8k16 over 16-wide hidden chunks (mma_bf16.cuh).
// The forward pass's gate 1 - h^2 of each chunk waits for the pullback in a
// private shared-memory slot of the lane that computed it (8 floats a chunk
// and tile); the accumulators of y and of u1 become the A fragments of the
// next product in registers.
//
// What bounds it on the H100: latency, as bf16 K3 (4 dz H multiply-adds a
// sample and evaluation at the flagship; the stage loop's barriers, tanh,
// the grid barrier of each attempted step).

#include "mma_bf16.cuh"

namespace {

constexpr int kStageUnroll = 1;
constexpr int kMaxT = 128;

using cnf::FwdArgs;
using cnf::kRedFloats;
using cnf::safe_norm_sq;
namespace bf = cnf::bf16;

template <int DZ>
struct TrainField {
  bf::Net n;
  const float* eps;  // (B, dz)
  float* gates;      // per warp 2 * (HP / 16) * 256 floats: the lanes' private 1 - h^2
  int zp, B, norm_z, norm_j;

  __device__ void operator()(int s0, int nv, const float* Z, float* KY, float* KR) const {
    const int warp = threadIdx.x >> 5, nch = n.HP / 16, dz = n.dz;
    float* mine = gates + (size_t)warp * 2 * nch * 256;
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = warp * 32 + mt * 16;
      uint32_t az[DZ / 16][4];
#pragma unroll
      for (int ks = 0; ks < DZ / 16; ++ks) bf::load_a_f32(az[ks], Z, zp, r0, ks * 16, dz);
      // Forward: h = tanh(z W1 + b1) a chunk at a time, y = tanh(h W2 + b2).
      float y[DZ / 8][4] = {};
#pragma unroll 1
      for (int c = 0; c < nch; ++c) {
        float a1[2][4], h[2][4];
        bf::chunk_mm<DZ>(a1, az, n.w1t, n.PZ, c);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float hv = tanhf(a1[t][e] + n.b1[c * 16 + bf::c_col(t, e)]);
            h[t][e] = hv;
            *bf::priv(mine, nch, mt, c, t * 4 + e) = 1.f - hv * hv;
          }
        uint32_t ah[4];
        bf::c_to_a(ah, h[0], h[1]);
        bf::chunk_acc<DZ>(y, ah, n.w2t, n.PH, c);
      }
      // v1 = eps (1 - y^2); the norm of y.
      float e[DZ / 8][4], v1[DZ / 8][4], ysq[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < DZ / 8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = bf::c_col(t, i), row = r0 + bf::c_row(i);
          const float yv = tanhf(y[t][i] + n.b2[k]);
          y[t][i] = yv;
          e[t][i] = (row < nv && k < dz) ? eps[(size_t)(s0 + row) * dz + k] : 0.f;
          v1[t][i] = e[t][i] * (1.f - yv * yv);
          ysq[i >> 1] = fmaf(yv, yv, ysq[i >> 1]);
        }
      // The pullback: u1 = v1 W2^T, v0 = u1 (1 - h^2), eJ = v0 W1^T.
      uint32_t av1[DZ / 16][4];
      bf::vec_to_a<DZ>(av1, v1);
      float eJ[DZ / 8][4] = {};
#pragma unroll 1
      for (int c = 0; c < nch; ++c) {
        float u1[2][4];
        bf::chunk_mm<DZ>(u1, av1, n.w2r, n.PZ, c);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) u1[t][i] *= *bf::priv(mine, nch, mt, c, t * 4 + i);
        uint32_t av0[4];
        bf::c_to_a(av0, u1[0], u1[1]);
        bf::chunk_acc<DZ>(eJ, av0, n.w1r, n.PH, c);
      }
      float tr[2] = {0.f, 0.f}, nsq[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < DZ / 8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tr[i >> 1] = fmaf(eJ[t][i], e[t][i], tr[i >> 1]);
          nsq[i >> 1] = fmaf(eJ[t][i], eJ[t][i], nsq[i >> 1]);
          const int k = bf::c_col(t, i);
          if (k < dz) KY[(r0 + bf::c_row(i)) * zp + k] = y[t][i];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float trs = bf::quad_sum(tr[half]), ns = bf::quad_sum(nsq[half]), ys = bf::quad_sum(ysq[half]);
        if ((threadIdx.x & 3) == 0) {
          float* kr = KR + 3 * (r0 + bf::c_row(2 * half));
          kr[0] = -trs;
          kr[1] = norm_z ? safe_norm_sq(ys) : 0.f;
          kr[2] = norm_j ? safe_norm_sq(ns) : 0.f;
        }
      }
    }
    __syncthreads();
  }
};

template <int DZ>
size_t smem_bytes(int dz, int H, int block) {
  const size_t gates = (size_t)(block / 32) * 2 * (bf::round16(H) / 16) * 256;
  return bf::net_bytes<DZ>(H, false) +
         sizeof(float) * (kRedFloats + (size_t)block * (2 * cnf::tile_pitch(dz) + 3) + gates);
}

template <int DZ>
__global__ void __launch_bounds__(kMaxT) k1_bf16_solve(const FwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bf::Net n = bf::load_net<DZ>(p.w1, p.b1, p.w2, p.b2, p.dz, p.H, false, smem);
  float* red = reinterpret_cast<float*>(smem + bf::net_bytes<DZ>(p.H, false));
  float* scratch = red + kRedFloats;  // the solver's Z, KY, KR
  float* gates = scratch + blockDim.x * (2 * cnf::tile_pitch(p.dz) + 3);
  const TrainField<DZ> field{n, p.eps, gates, cnf::tile_pitch(p.dz), p.B, p.norm_z, p.norm_j};
  cnf::forward_solve_tiles<3, kStageUnroll>(p, field, blockDim.x, scratch, red);
}

}  // namespace

// Dynamic shared memory of one block of `block` threads (bytes), 0 for an
// unsupported dz.
extern "C" long long cnf_k1b_smem_bytes(int dz, int H, int block) {
  switch (bf::padded_dz(dz)) {
    case 16: return (long long)smem_bytes<16>(dz, H, block);
    case 32: return (long long)smem_bytes<32>(dz, H, block);
    default: return 0;
  }
}

// Largest co-resident grid for a cooperative launch (0 if none).
extern "C" int cnf_k1b_max_grid(int dz, int H, int block, int* out) {
  if (block > kMaxT || block % 32 != 0) return (int)cudaErrorInvalidValue;
  switch (bf::padded_dz(dz)) {
    case 16: return (int)cnf::coop_max_grid(k1_bf16_solve<16>, smem_bytes<16>(dz, H, block), block, out);
    case 32: return (int)cnf::coop_max_grid(k1_bf16_solve<32>, smem_bytes<32>(dz, H, block), block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The arguments of cnf_k1_train_solve (k1_train_solve.cu): eps (B, dz) the
// probe, acc0/accT (3, B), work (S + 2) (dz + 3) B floats, partials 6 grid.
// A block is a tile of `block` samples (a multiple of 32, at most 128).
// Returns the launch's cudaError_t.
extern "C" int cnf_k1b_train_solve(const float* w1, const float* b1, const float* w2, const float* b2,
                                   const float* eps, const float* z0, const float* acc0, const float* ts, float* zT,
                                   float* accT, int* stats, float* dt_last, float* work, float* partials, int B,
                                   int dz, int H, int max_steps, int norm_z, int norm_j, float rtol, float atol,
                                   float beta1, float beta2, float inv_order, const float* tab, int grid, int block,
                                   void* stream) {
  if (block < 32 || block > kMaxT || block % 32 != 0 || grid < 1 || H < 1) return (int)cudaErrorInvalidValue;
  FwdArgs a;
  cnf::set_fwd_args(&a, eps, z0, acc0, ts, zT, accT, stats, dt_last, work, partials, B, dz, max_steps, norm_z,
                    norm_j, rtol, atol, beta1, beta2, inv_order, tab);
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2; a.H = H;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bf::padded_dz(dz)) {
    case 16: return (int)cnf::coop_launch(k1_bf16_solve<16>, a, grid, block, smem_bytes<16>(dz, H, block), s);
    case 32: return (int)cnf::coop_launch(k1_bf16_solve<32>, a, grid, block, smem_bytes<32>(dz, H, block), s);
    default: return (int)cudaErrorInvalidValue;
  }
}
