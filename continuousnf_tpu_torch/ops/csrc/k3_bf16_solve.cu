// bf16 K3: K3's TEST-mode forward solve (k3_test_solve.cu) with the stage
// matmuls on the tensor cores in bf16, for a CNF whose field is an
// unconditional 2-layer tanh MLP of state width up to 32: the whole adaptive
// solve (any embedded explicit tableau, K9) in one cooperative launch.
//
// Replaces the TPU kernel continuousnf_tpu/ops/fused_solve.py::_run_solve_kernel
// (pl.pallas_call at :1043) built by _make_solve_kernel (:773-942) with the
// _stage_test stage (:484-503) under ComputeMode.bf16 (`bf16 = "bf16"`,
// :1464-1465): every stage product from bf16-rounded operands (round to
// nearest even) with f32 sums (_mm, :193-225):
//   a1 = bf16(z) bf16(W1) + b1, h = tanh(a1), dh = 1 - h^2,
//   y = tanh(bf16(h) bf16(W2) + b2), dy = 1 - y^2,
//   tr = sum_i dy_i (bf16(dh) bf16(M)^T)_i, M = W1 * W2^T formed in f32 and
//   then rounded (not the product of the rounded weights);
// the biases, tanh, the gates, the trace sum, the state, the RK combination,
// the error norm and the controller stay f32.  The plain twin is
// fused_solve.py::solve_test_plain(bf16=True) (`_test_stage_bf16`).
//
// Design: forward_solve_tiles of solve_common.cuh with NACC = 1 and a tile
// of T = blockDim samples; each warp evaluates its 32 rows of the tile as two
// m16 tiles with mma.sync m16n8k16 (mma_bf16.cuh): z W1 is DZ / 16 k-steps
// over two n8 tiles a hidden chunk of 16; the chunk's h and dh, after the
// bias and tanh, are packed straight from the accumulators into the A
// fragments of h W2 and dh M^T (one k16 step each over DZ / 8 n8 tiles), so
// no hidden vector leaves the registers.  Weights and M are rounded once per
// launch into shared memory and read with ldmatrix.  The trace is a row sum
// over the quad of lanes of each row.  Every lane of every warp runs the
// field: rows past the batch hold zeros (tile_stage_input) and are not
// stored, so no warp diverges around an mma.sync.
//
// What bounds it on the H100: latency.  At the flagship (dz 16, H 48) a stage
// is 3 dz H = 2.3 k multiply-adds a sample, 19 MFLOP at B = 4096: 19 ns at
// the card's 989 TFLOP/s bf16 rate.  The time goes to the stage loop's block
// barriers, the tile's trips through shared memory, tanh, and one grid
// barrier an attempted step, and bf16's noise floor multiplies the attempted
// steps (PERF.md).

#include "mma_bf16.cuh"

namespace {

constexpr int kStageUnroll = 1;
constexpr int kMaxT = 128;

using cnf::FwdArgs;
using cnf::kRedFloats;
namespace bf = cnf::bf16;

// The TEST field of a tile: KY = y, KR = -tr per row, every warp on its 32
// rows.
template <int DZ>
struct TestField {
  bf::Net n;
  int zp;

  __device__ void operator()(int, int, const float* Z, float* KY, float* KR) const {
    const int warp = threadIdx.x >> 5, nch = n.HP / 16;
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = warp * 32 + mt * 16;
      uint32_t az[DZ / 16][4];
#pragma unroll
      for (int ks = 0; ks < DZ / 16; ++ks) bf::load_a_f32(az[ks], Z, zp, r0, ks * 16, n.dz);
      float y[DZ / 8][4] = {}, md[DZ / 8][4] = {};
#pragma unroll 1
      for (int c = 0; c < nch; ++c) {
        float a1[2][4];
        bf::chunk_mm<DZ>(a1, az, n.w1t, n.PZ, c);
        float h[2][4], d[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float hv = tanhf(a1[t][e] + n.b1[c * 16 + bf::c_col(t, e)]);
            h[t][e] = hv;
            d[t][e] = 1.f - hv * hv;
          }
        uint32_t ah[4], ad[4];
        bf::c_to_a(ah, h[0], h[1]);
        bf::c_to_a(ad, d[0], d[1]);
        bf::chunk_acc<DZ>(y, ah, n.w2t, n.PH, c);
        bf::chunk_acc<DZ>(md, ad, n.mr, n.PH, c);
      }
      float tr[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < DZ / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = bf::c_col(t, e), row = r0 + bf::c_row(e);
          const float yv = tanhf(y[t][e] + n.b2[k]);
          tr[e >> 1] = fmaf(1.f - yv * yv, md[t][e], tr[e >> 1]);
          if (k < n.dz) KY[row * zp + k] = yv;
        }
      tr[0] = bf::quad_sum(tr[0]);
      tr[1] = bf::quad_sum(tr[1]);
      if ((threadIdx.x & 3) == 0) {
        KR[r0 + bf::c_row(0)] = -tr[0];
        KR[r0 + bf::c_row(2)] = -tr[1];
      }
    }
    __syncthreads();
  }
};

template <int DZ>
size_t smem_bytes(int dz, int H, int block) {
  return bf::net_bytes<DZ>(H, true) + sizeof(float) * (kRedFloats + (size_t)block * (2 * cnf::tile_pitch(dz) + 1));
}

template <int DZ>
__global__ void __launch_bounds__(kMaxT) k3_bf16_solve(const FwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bf::Net n = bf::load_net<DZ>(p.w1, p.b1, p.w2, p.b2, p.dz, p.H, true, smem);
  float* red = reinterpret_cast<float*>(smem + bf::net_bytes<DZ>(p.H, true));
  float* scratch = red + kRedFloats;  // the solver's Z, KY, KR
  const TestField<DZ> field{n, cnf::tile_pitch(p.dz)};
  cnf::forward_solve_tiles<1, kStageUnroll>(p, field, blockDim.x, scratch, red);
}

}  // namespace

// Dynamic shared memory of one block of `block` threads (bytes), 0 for an
// unsupported dz.
extern "C" long long cnf_k3b_smem_bytes(int dz, int H, int block) {
  switch (bf::padded_dz(dz)) {
    case 16: return (long long)smem_bytes<16>(dz, H, block);
    case 32: return (long long)smem_bytes<32>(dz, H, block);
    default: return 0;
  }
}

// Largest co-resident grid for a cooperative launch (0 if none).
extern "C" int cnf_k3b_max_grid(int dz, int H, int block, int* out) {
  if (block > kMaxT || block % 32 != 0) return (int)cudaErrorInvalidValue;
  switch (bf::padded_dz(dz)) {
    case 16: return (int)cnf::coop_max_grid(k3_bf16_solve<16>, smem_bytes<16>(dz, H, block), block, out);
    case 32: return (int)cnf::coop_max_grid(k3_bf16_solve<32>, smem_bytes<32>(dz, H, block), block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The arguments of cnf_k3_test_solve (k3_test_solve.cu): w1 (dz, H), b1, w2
// (H, dz), b2, z0 (B, dz), dlogp0/dlogpT (B), ts (t0, t1, dt_init), dt_last
// (2): the next step size and the last step taken; work (S + 2) (dz + 1) B
// floats; partials 6 grid.  A block is a tile of `block` samples (a multiple
// of 32, at most 128).  Returns the launch's cudaError_t.
extern "C" int cnf_k3b_test_solve(const float* w1, const float* b1, const float* w2, const float* b2,
                                  const float* z0, const float* dlogp0, const float* ts, float* zT, float* dlogpT,
                                  int* stats, float* dt_last, float* work, float* partials, int B, int dz, int H,
                                  int max_steps, float rtol, float atol, float beta1, float beta2, float inv_order,
                                  const float* tab, int grid, int block, void* stream) {
  if (block < 32 || block > kMaxT || block % 32 != 0 || grid < 1 || H < 1) return (int)cudaErrorInvalidValue;
  FwdArgs a;
  cnf::set_fwd_args(&a, nullptr, z0, dlogp0, ts, zT, dlogpT, stats, dt_last, work, partials, B, dz, max_steps, 0, 0,
                    rtol, atol, beta1, beta2, inv_order, tab);
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2; a.H = H;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bf::padded_dz(dz)) {
    case 16: return (int)cnf::coop_launch(k3_bf16_solve<16>, a, grid, block, smem_bytes<16>(dz, H, block), s);
    case 32: return (int)cnf::coop_launch(k3_bf16_solve<32>, a, grid, block, smem_bytes<32>(dz, H, block), s);
    default: return (int)cudaErrorInvalidValue;
  }
}
