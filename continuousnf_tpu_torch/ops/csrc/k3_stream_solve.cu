// Streamed K3: the TEST-mode forward solve of a CNF whose field is a 2-layer
// tanh MLP past the wide 2-layer kernels' limits (state width 33 to 128 with
// a hidden width past 128, or a state width past 64: the README net family
// MLP((n_in, 3 n_in, n_in)) at the MINIBOONE width, 86 -> 258 -> 86, and
// at BSDS300's, 126 -> 378 -> 126), the whole adaptive solve (any embedded
// explicit tableau, K9) in one cooperative launch.
//
// Replaces, at these widths, the TPU kernel continuousnf_tpu/ops/fused_solve.py::
// _run_solve_kernel (pl.pallas_call at :1043) built by _make_solve_kernel
// (:773-942) with the _stage_test stage (:484-503): the state [z | dlogp],
// the field y = tanh(tanh(z W1 + b1) W2 + b2) and the dlogp rate
// -tr J = -sum_i dy_i (M dh)_i, M[i, h] = W1[i, h] W2[h, i].  Wide K3
// (k3_wide_solve.cu) keeps the weights and M in shared memory up to dz 64
// and H 128; here they stay in global memory.  Streamed K7 TEST would also
// compute this trace, by pushing dz basis columns through the net: dz^2 H a
// sample and evaluation, dz / 3 times the closed form's 3 dz H (29x at 86
// wide).
//
// Design: forward_solve_tiles of solve_common.cuh with NACC = 1.  First the
// grid builds M into a global scratch (two_layer_stream.cuh) and meets at a
// grid barrier.  A block then evaluates each stage for a tile of T = 32
// samples (16 or 8 where the shared memory asks for it): h and dh (a hidden
// row each), y and dy, and M dh as a transposed product against M, all
// through chain_stream.cuh's chunk products (the weights and M L2-resident,
// streamed through a 17 KB chunk buffer).  Shared memory at 86 -> 258 -> 86
// and T = 32: the chunk buffer, and per tile row the solver's z, y and rate
// (2 x 88 + 1), h and dh (2 x 260), dy and M dh (2 x 88): 873 floats,
// 27,936 at T = 32; 129 KB in all.  Past that the tile arrays go to a
// global scratch.  B = 4096 gives 128 tiles for 132 SMs.
// What bounds it on the H100: a stage is 3 dz H = 66.6 k FMA a sample at
// 86 -> 258 -> 86, 0.55 GFLOP at B = 4096, 8 us at the card's f32 rate.
// Each weight read from the L2 serves the tile's 32 rows; the chunks' L2
// latency, the products' barriers and each attempted step's grid barrier
// take the rest.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The COND instance (K8 in the streamed forms): the closed-form _stage_test
// of a conditional 2-layer net past the wide limits (:484-503 with _zin
// :265: CondRNODE at the MINIBOONE width, 87 -> 258 -> 86, one ys column).
// W1's ys rows enter the pre-activation of h (stream_two_layer_forward
// <true>, from the tile's (T, nc) ys rows, read from global memory at each
// evaluation), while M and the trace read W1's z rows only.  At
// cond_miniboone86 that adds 258 FMA to the stage's 66,564 a sample.  Its
// tile arrays are the unconditional instance's and the (T, nc) ys rows; its
// launch shape and entry are cnf_k3sc_shape and cnf_k3s_cond_solve.

#include "two_layer_stream.cuh"

namespace {

constexpr int kStageUnroll = 1;
constexpr int kTiles[] = {32, 16, 8};

using cnf::kRedFloats;
using cnf::kStreamBlock;
using cnf::StreamLayout;

struct Args {
  cnf::FwdArgs f;
  StreamLayout L;
  const float* params;  // [W1 | b1 | W2 | b2]
  float* m;             // (dz, H): M, built by the launch
  float* tiles;         // global scratch of the tile arrays (grid x region), null: shared memory
  int T;                // samples a tile
};

// The tile arrays: the solver's Z, KY, KR, then h, dh, dy and M dh.
__host__ __device__ inline size_t region_floats(const StreamLayout& L, int T) {
  return (size_t)T * (2 * L.zp + 1) + (size_t)T * (2 * L.hp[1] + 2 * L.zp);
}

// A COND field's conditioning: ys (B, nc) in global memory and the tile's
// (T, nc) rows; nothing in an unconditional field.
template <bool COND>
struct CondRows {};
template <>
struct CondRows<true> {
  const float* ys;
  float* YS;
};

// The TEST field of a tile: KY = y, KR = -tr per row.
template <bool COND>
struct StreamTestField : CondRows<COND> {
  const StreamLayout* L;
  const float* params;
  const float* m;    // M (dz, H) in global memory
  float *HS, *DH;    // (T, hp)
  float *DY, *MDH;   // (T, zp)
  float* wc;         // the chunk buffer
  int T;

  __device__ void operator()([[maybe_unused]] int s0, [[maybe_unused]] int nv, const float* Z, float* KY,
                             float* KR) const {
    const StreamLayout& c = *L;
    const int dz = c.dz, zp = c.zp;
    if constexpr (COND) {
      cnf::load_tile_cond(this->ys, cnf::stream_nc(c), s0, nv, T, this->YS);
      cnf::stream_two_layer_forward<true>(c, params, Z, T, HS, DH, KY, DY, wc, this->YS);
    } else {
      cnf::stream_two_layer_forward(c, params, Z, T, HS, DH, KY, DY, wc);
    }
    cnf::stream_m_dh(c, m, DH, T, MDH, wc);
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float tr = 0.f;
      for (int k = 0; k < dz; ++k) tr = fmaf(DY[t * zp + k], MDH[t * zp + k], tr);
      KR[t] = -tr;
    }
    __syncthreads();
  }
};

__global__ void __launch_bounds__(kStreamBlock) k3_stream_solve(const Args p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  cnf::share_layout(p.L, &L);
  cnf::build_stream_m(L, p.params, p.m);
  const int T = p.T;
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * region_floats(L, T) : red + kRedFloats;  // Z, KY, KR
  float* HS = scratch + T * (2 * L.zp + 1);
  float* DH = HS + T * L.hp[1];
  float* DY = DH + T * L.hp[1];
  float* MDH = DY + T * L.zp;
  const StreamTestField<false> field{{}, &L, p.params, p.m, HS, DH, DY, MDH, wc, T};
  cnf::forward_solve_tiles<1, kStageUnroll>(p.f, field, T, scratch, red);
}

size_t smem_bytes(const StreamLayout& L, int T, bool global_tiles) {
  return sizeof(float) * ((size_t)cnf::kChunkFloats + kRedFloats + (global_tiles ? 0 : region_floats(L, T)));
}

// The COND instance's arguments: the unconditional instance's and the
// conditioning ys (B, nc).
struct CondArgs {
  Args a;
  const float* ys;
};

// The COND instance's tile arrays: the unconditional instance's and the
// tile's ys rows (T, nc), in shared memory or in the block's slice of the
// global scratch alike.
__host__ __device__ inline size_t cond_region_floats(const StreamLayout& L, int T) {
  return region_floats(L, T) + (size_t)T * cnf::stream_nc(L);
}

__global__ void __launch_bounds__(kStreamBlock) k3_stream_cond_solve(const __grid_constant__ CondArgs ca) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  const Args& p = ca.a;
  cnf::share_layout(p.L, &L);
  cnf::build_stream_m(L, p.params, p.m);
  const int T = p.T;
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * cond_region_floats(L, T) : red + kRedFloats;
  float* HS = scratch + T * (2 * L.zp + 1);
  float* DH = HS + T * L.hp[1];
  float* DY = DH + T * L.hp[1];
  float* MDH = DY + T * L.zp;
  float* YS = MDH + T * L.zp;
  const StreamTestField<true> field{{ca.ys, YS}, &L, p.params, p.m, HS, DH, DY, MDH, wc, T};
  cnf::forward_solve_tiles<1, kStageUnroll>(p.f, field, T, scratch, red);
}

size_t cond_smem_bytes(const StreamLayout& L, int T, bool global_tiles) {
  return sizeof(float) * ((size_t)cnf::kChunkFloats + kRedFloats + (global_tiles ? 0 : cond_region_floats(L, T)));
}

}  // namespace

// The launch shape at batch B: out = {threads per block, blocks, samples a
// tile, dynamic shared memory bytes, floats of global tile scratch a block
// (0: the tile arrays are in shared memory)}.  widths: the 3 level widths
// (host memory).  Returns a cudaError_t (cudaErrorInvalidValue for a net not
// covered).
extern "C" int cnf_k3s_shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || n != 2 || !cnf::make_stream_layout(n, widths, &L)) return (int)cudaErrorInvalidValue;
  size_t region[3];
  for (int o = 0; o < 3; ++o) region[o] = region_floats(L, kTiles[o]);
  return cnf::stream_shape(k3_stream_solve, region, kTiles, kTiles, 3, B, out);
}

// params [W1 | b1 | W2 | b2] flat (device), acts: 3 (both layers tanh), z0
// (B, dz), dlogp0/dlogpT (B), dt_last (2): the next step size and the last
// step taken; work: (S + 2) (dz + 1) B floats; partials: 6 grid; m: dz H
// floats (M, written by the launch); tiles: grid x out[4] floats of
// cnf_k3s_shape, or null when out[4] is 0.  tab: kTableauFloats floats
// (read_tableau).  T, grid, block: from cnf_k3s_shape.  Returns the
// launch's cudaError_t.
extern "C" int cnf_k3s_test_solve(const float* params, const float* z0, const float* dlogp0, const float* ts,
                                  float* zT, float* dlogpT, int* stats, float* dt_last, float* work, float* partials,
                                  float* m, float* tiles, int B, int n, const int* widths, int acts, int max_steps,
                                  float rtol, float atol, float beta1, float beta2, float inv_order, const float* tab,
                                  int T, int grid, int block, void* stream) {
  Args a = {};
  if (block != kStreamBlock || grid < 1 || T < 4 || T % 4 != 0 || !cnf::make_stream_layout(n, widths, &a.L) ||
      !cnf::stream_two_layer_tanh(a.L, acts) || m == nullptr)
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_fwd_args(&a.f, nullptr, z0, dlogp0, ts, zT, dlogpT, stats, dt_last, work, partials, B, widths[n],
                    max_steps, 0, 0, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.m = m;
  a.tiles = tiles;
  a.T = T;
  return (int)cnf::coop_launch(k3_stream_solve, a, grid, block, smem_bytes(a.L, T, tiles != nullptr),
                               (cudaStream_t)stream);
}

// The COND instance's launch shape (K8), as cnf_k3s_shape; widths[0] =
// dz + nc with nc >= 1, out[4] counting the tile's ys rows.
extern "C" int cnf_k3sc_shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || n != 2 || !cnf::make_stream_layout(n, widths, &L, true)) return (int)cudaErrorInvalidValue;
  size_t region[3];
  for (int o = 0; o < 3; ++o) region[o] = cond_region_floats(L, kTiles[o]);
  return cnf::stream_shape(k3_stream_cond_solve, region, kTiles, kTiles, 3, B, out);
}

// The COND instance (K8): as cnf_k3s_test_solve for a conditional net, with
// ys (B, nc) (device), nc = widths[0] - widths[2] >= 1; T, grid, block and
// the tile scratch from cnf_k3sc_shape.
extern "C" int cnf_k3s_cond_solve(const float* params, const float* ys, const float* z0, const float* dlogp0,
                                  const float* ts, float* zT, float* dlogpT, int* stats, float* dt_last, float* work,
                                  float* partials, float* m, float* tiles, int B, int n, const int* widths, int acts,
                                  int max_steps, float rtol, float atol, float beta1, float beta2, float inv_order,
                                  const float* tab, int T, int grid, int block, void* stream) {
  CondArgs ca = {};
  Args& a = ca.a;
  if (block != kStreamBlock || grid < 1 || T < 4 || T % 4 != 0 || ys == nullptr ||
      !cnf::make_stream_layout(n, widths, &a.L, true) || !cnf::stream_two_layer_tanh(a.L, acts) || m == nullptr)
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_fwd_args(&a.f, nullptr, z0, dlogp0, ts, zT, dlogpT, stats, dt_last, work, partials, B, widths[n],
                    max_steps, 0, 0, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.m = m;
  a.tiles = tiles;
  a.T = T;
  ca.ys = ys;
  return (int)cnf::coop_launch(k3_stream_cond_solve, ca, grid, block, cond_smem_bytes(a.L, T, tiles != nullptr),
                               (cudaStream_t)stream);
}
