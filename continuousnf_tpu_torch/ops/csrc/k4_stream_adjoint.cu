// The streamed K4 adjoint: the continuous-adjoint (backsolve) backward
// integration of an exact-trace TRAIN-mode CNF whose field is an
// unconditional 2-layer tanh MLP past the wide 2-layer kernels' limits
// (state width 33 to 128 with a hidden width past 128, or a state width past
// 64: the README net family at the MINIBOONE and BSDS300 widths,
// 86 -> 258 -> 86 and 126 -> 378 -> 126), the whole adaptive solve (any
// embedded explicit tableau, K9) from t_hi down to t_lo in one cooperative
// launch.
//
// Replaces, at these widths, the TPU kernel built by continuousnf_tpu/ops/
// fused_solve.py::_make_adjoint_kernel (:1064-1343), launched by
// make_full_solve.adjoint_solve (pl.pallas_call at :1767), with the
// _stage_train_exact_fwdbwd stage (:618-675); the pm chaining of :1787-1799
// stays a product after the launch, as there.  The state is, per sample,
// z (dz), acc (3: dlogp, reg_e, reg_n), a_z (dz) and the constant a_acc (3),
// plus the batch-summed gradient g = [W1 (dz, H) | b1 | W2 (H, dz) | b2 |
// g_pm (dz^2, H)] of P_total = P + dz^2 H floats (1,952,888 at 86 -> 258 ->
// 86, 6,096,888 at 126 -> 378 -> 126).  g_pm stays in the state and in the
// one batch-global error norm: the single-tile numerics of the K4 adjoint.
//
// Per sample and stage, the math of the wide K4 adjoint (k4_wide_adjoint.cu):
//   forward:  h, dh, y, dy; the rows of m[j, i] = sum_h W1[j, h] dh_h W2[h, i]
//             ((dh (.) W1[j, :]) W2), d_i = m[i, i], s_i = sum_j m[j, i]^2;
//   backward: ct_m[j, i] = [i = j] dy_i ct_tr + 2 dy_i^2 ct_fro2 m[j, i];
//             ct_dh[h] = sum_j W1[j, h] sum_i W2[h, i] ct_m[j, i]; ct_pre2,
//             ct_pre1, k_az = -W1 ct_pre1;
//   gradient: W1 <- z (x) ct_pre1, W2 <- h (x) ct_pre2, the biases ct_pre1
//             and ct_pre2, g_pm[(j, i), h] <- ct_m[j, i] dh_h.
//
// Why not the wide K4 adjoint's reduction: it keeps, in every block, its
// own (NG + 2) P_total-float vectors of g rates and rereads and rewrites two
// of them per tile and stage (7.8 MB each at 86 -> 258 -> 86, 4.1 GB over
// 132 blocks).  Here no block holds a P_total-long private vector.  Each
// stage runs in two phases between grid barriers:
//   1. The per-sample pass.  A block evaluates the stage for its tiles of T
//      samples and writes the factors of the gradient rate to a global
//      scratch, laid out (rows, B) sample-minor: ct_m (dz^2, B; first m,
//      rewritten in place), dh, ct_pre1 and h (H, B), z and ct_pre2
//      (dz, B), and a row of ones under z and under h for the biases.  The
//      (dz^2, B) scratch takes 121 MB at 86 -> 258 -> 86 with B = 4096; its
//      offsets are 64-bit.  The forward and the two chain VJPs stream the
//      weights from the L2 through chain_stream.cuh's chunk products; the
//      m rows and the ct_m push, 2 dz^2 H FMA a sample, run as tile GEMMs
//      over the tile's T dz basis rows (row j T + t): m = (dh (.) W1[j, :])
//      W2 and (ct_m W2^T) (.) W1[j, :], in block tiles of 128 rows (whole
//      j) by 64 to 128 columns, 8 x 4 to 8 x 8 a thread in registers, k in
//      chunks of 16 through shared memory with the next chunk's values in
//      registers; the j-order sums (s_i, ct_dh) run over each block tile's
//      staged output (W2^T is built once per launch).
//   2. Grid barrier, then the batch-wide contraction.  g splits into three
//      products, each a (rows, B) x (B, cols) product over the whole batch:
//      [W1 | b1] = [z | 1]^T ct_pre1, [W2 | b2] = [h | 1]^T ct_pre2 and
//      g_pm = ct_m^T dh, the dominant term.  Their tasks (64 rows by up to
//      256 columns) are dealt to the blocks in a fixed order, so block b
//      owns a fixed slice of the g entries: it sums each of its entries over
//      all B samples in sample order (chunks of 32 samples copied with
//      cp.async, two buffers), and keeps the slice's b-, btilde- (and
//      btilde3-) weighted rates, its stage-1 and last-stage rates, g and
//      the proposal in global vectors only it touches.  A second grid
//      barrier (after every stage but the last) keeps the next stage's
//      per-sample pass from overwriting factors still being read.
// After the stages each block forms its slice's proposal and error sum;
// the per-sample rows' sums and the slices' sums go to the partials, one
// grid barrier shares them, and every block adds them in block order, so
// every block takes bitwise the same accept/reject decisions.  Every g
// entry is summed once, in one fixed order.
//
// Memory plan.  Shared memory: the chunk buffer of the streamed products,
// the reduction slots, the tile GEMM's buffers (80 KB), and the tile
// arrays when they fit; the contraction's two chunks (83 KB) lie over the
// last two outside the stages.  Per tile row the solver's z, a_z, k_z
// (= y), k_az (4 zp) and rates (3), h, dh and ct_dh then ct_pre1 (3 hp),
// dy, ct_pre2, d then ct_d, s then ct_s (4 zp) and four floats, and the
// rows of W1 a block tile reads (128 / T hp): T = 16 at 86 -> 258 -> 86
// (199 KB in all), T = 8 at 126 -> 378 -> 126 (189 KB); past that the tile
// arrays go to a global scratch.  Global: the (row, B) planes of the
// per-sample state, the factors (B (dz^2 + 3 H + 2 dz + 2) floats), W2^T,
// the (NG + 2) P_total slice vectors, g and its proposal.
//
// What bounds it on the H100: a stage is about 3 dz^2 H + 6 dz H FMA a
// sample (the m rows, the ct_m push, the g_pm contraction), 24.0 GFMA at
// 86 -> 258 -> 86 and B = 4096, 716 us at the card's f32 rate; the factors
// move 4 dz^2 B floats a stage through the HBM (m written, read, ct_m
// written, read: 484 MB, 145 us).  Measured by chip_smoke.py on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md): 5.6x that bound an attempted step.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.
//
// The COND instance (K8 in the streamed forms: k4_stream_cond_adjoint):
// _stage_train_exact_fwdbwd on _zin of a conditional net whose W1 reads
// [z | ys], ys (B, nc) constant over the solve (CondRNODE at the MINIBOONE
// width, 87 -> 258 -> 86), as the wide K4 adjoint's COND instance.  The
// forward adds W1's ys rows times the tile's (T, nc) ys rows to h's
// pre-activation (stream_two_layer_forward<true>); the m rows, the ct_m
// push and g_pm read W1's z rows alone (W1C holds rows j < dz), and the
// launch chains g_pm into them (the ys rows get zeros, the JAX package's
// :1787-1799).  k_az and k_ays = -(W1's ys rows ct_pre1) come from one
// transposed product over W1's dz + nc rows.  Each sample's a_ys (nc rows
// more, 2 dz + 3 + nc) integrates k_ays from 0 at t_hi, combined like a_z,
// inside the one batch-global norm (n_elems gains B nc), a_ys0 (B, nc)
// returned.  The factor zx becomes [z | ys | 1] (dz + nc + 1, B), so that
// the [W1 | b1] contraction's dz + nc rows give W1's ys rows ys (x)
// ct_pre1 summed over the batch in the same fixed order.  The tile's ys
// rows and k_ays take 2 nc floats a row more.  Its launch shape and entry
// are cnf_k4sc_shape and cnf_k4s_cond_exact_adjoint.

#include "two_layer_stream.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kStageUnroll = 4;
// Samples a tile, largest first (powers of two).
constexpr int kOptions = 3;
constexpr int kTiles[kOptions] = {32, 16, 8};
// The tile GEMM of the basis-row products (tile_gemm): block tiles of kGM
// rows by 16 NC columns (NC <= 8: kGN at most), k in chunks of kGK; a
// thread keeps 8 rows by NC columns in registers (16 x 16 threads).
constexpr int kGM = 128;
constexpr int kGN = 128;
constexpr int kGK = 16;
constexpr int kGemmFloats = kGK * kGM + kGK * kGN + kGM * kGN;
// The contraction: a task is kCRows g rows by up to kCCols columns, a
// thread 8 rows by up to 8 columns in registers (256 threads: 8 warps of
// rows, 32 lanes of columns), summed over the batch kCS samples a chunk.
// A chunk: A as (kCS, kAPitch), a sample's 64 rows contiguous (a thread
// reads its 8 as two float4 broadcasts), B as (kCCols, kBPitch), odd (a
// warp's lanes read 32 banks); two chunks, the next one's copies in flight.
constexpr int kCRows = 64;
constexpr int kCCols = 256;
constexpr int kCS = 32;
constexpr int kAPitch = kCRows + 4;
constexpr int kBPitch = kCS + 1;
constexpr int kChunkCFloats = kCS * kAPitch + kCCols * kBPitch;
constexpr int kContractFloats = 2 * kChunkCFloats;
// Dynamic shared memory: the chunk buffer of the streamed products, the
// reduction slots, then at kWorkOffset the tile GEMM's buffers followed by
// the tile arrays (when they fit), or, outside the stages, the
// contraction's chunks over both.  The functions that read them derive
// their pointers from the shared symbol, so the loads are shared-memory
// loads.
constexpr int kWorkOffset = cnf::kChunkFloats + cnf::kRedFloats;

using cnf::ct_safe_norm;
using cnf::kRedFloats;
using cnf::kStreamBlock;
using cnf::safe_norm_sq;
using cnf::StreamLayout;

// The per-sample factors of a stage's gradient rate, each (rows, B).
struct Factors {
  float* ctm;  // (dz^2, B): m, then ct_m
  float* dh;   // (H, B)
  float* cp1;  // (H, B): ct_pre1
  float* zx;   // (dz + 1, B): z, then a row of ones (COND: (dz + nc + 1, B), [z | ys | 1])
  float* hx;   // (H + 1, B): h, then a row of ones
  float* cp2;  // (dz, B): ct_pre2
};

__device__ inline Factors factors(const StreamLayout& L, float* base, int B) {
  const size_t dz = L.dz, H = L.width[1], b = B;
  Factors f;
  f.ctm = base;
  f.dh = f.ctm + dz * dz * b;
  f.cp1 = f.dh + H * b;
  f.zx = f.cp1 + H * b;
  f.hx = f.zx + (dz + 1) * b;
  f.cp2 = f.hx + (H + 1) * b;
  return f;
}

struct AdjArgs {
  cnf::AdjState s;
  StreamLayout L;
  const float* params;  // [W1 | b1 | W2 | b2]
  float* g;             // (P_total) the gradient [W1 | b1 | W2 | b2 | g_pm]
  float* gnew;          // (P_total) its proposal
  float* gvec;          // (NG + 2) P_total: GB | GE | GE3 | stage-1 rate | last-stage rate
  float* fac;           // the factors: B (dz^2 + 3 H + 2 dz + 2) floats
  float* tiles;         // global scratch of the tile arrays (grid x region), null: shared memory
  float* w2t;           // (dz, H): W2^T, built by the launch
  int norm_z, norm_j, T;
};

struct TileArrays {
  float *HS, *DH, *CA;      // (T, hp): h, dh, ct_dh then ct_pre1
  float *DY, *CP2, *D, *S;  // (T, zp): dy, ct_pre2, d then ct_d, s then ct_s
  float* SC;                // (T, 4): ct_tr, ct_fro2, the norm factor
  float* W1C;               // (kGM / T, hp): the rows W1[j, :] of a block tile's j
};

// The tile arrays: the solver's Z, AZ, KZ, KAZ, KR and the stage's.
__host__ __device__ inline size_t region_floats(const StreamLayout& L, int T) {
  return (size_t)T * (4 * L.zp + 3) + (size_t)T * (3 * L.hp[1] + 4 * L.zp + 4) + (size_t)(kGM / T) * L.hp[1];
}

__device__ inline TileArrays tile_arrays(const StreamLayout& L, int T, float* base) {
  TileArrays a;
  const size_t v = (size_t)T * L.zp, h = (size_t)T * L.hp[1];
  a.HS = base;
  a.DH = a.HS + h;
  a.CA = a.DH + h;
  a.DY = a.CA + h;
  a.CP2 = a.DY + v;
  a.D = a.CP2 + v;
  a.S = a.D + v;
  a.SC = a.S + v;
  a.W1C = a.SC + 4 * T;
  return a;
}

// The tile GEMM: out(m, n) = sum_k fill_a(m, k) fill_b(k, n), k < K in k
// order from 0, for m < M and n < N, in block tiles of kGM rows by 16 NC
// columns.  A thread keeps rows 8 ty .. 8 ty + 7 of a tile (two float4
// broadcasts of the k-major As) by columns tx + 16 c (conflict-free reads
// of Bs); the next k chunk's values are fetched into registers while the
// block computes on the current one.  Per block tile: start(m0, mn) first,
// block-wide, between barriers (it may fill shared memory the fills read);
// after the k loop the tile goes to Cs (kGM, 16 NC) and end(m0, n0, mn,
// nn, 16 NC) reads it, block-wide, after a barrier.  Ends with a barrier.
template <int NC, class Start, class FillA, class FillB, class End>
__device__ void tile_gemm(int M, int N, int K, float* As, float* Bs, float* Cs, const Start& start,
                          const FillA& fill_a, const FillB& fill_b, const End& end) {
  constexpr int BN = 16 * NC;
  constexpr int LA = kGK * kGM / kStreamBlock;
  constexpr int LB = kGK * BN / kStreamBlock;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int m0 = 0; m0 < M; m0 += kGM) {
    const int mn = min(kGM, M - m0);
    __syncthreads();
    start(m0, mn);
    __syncthreads();
    for (int n0 = 0; n0 < N; n0 += BN) {
      const int nn = min(BN, N - n0);
      float acc[8][NC];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
      float va[LA], vb[LB];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int l = 0; l < LA; ++l) {
          const int e = threadIdx.x + l * kStreamBlock, m = e % kGM, k = e / kGM;
          va[l] = m < mn && k0 + k < K ? fill_a(m0 + m, k0 + k) : 0.f;
        }
#pragma unroll
        for (int l = 0; l < LB; ++l) {
          const int e = threadIdx.x + l * kStreamBlock, n = e % BN, k = e / BN;
          vb[l] = n < nn && k0 + k < K ? fill_b(k0 + k, n0 + n) : 0.f;
        }
      };
      fetch(0);
      for (int k0 = 0; k0 < K; k0 += kGK) {
        __syncthreads();  // the previous chunk's readers are done
#pragma unroll
        for (int l = 0; l < LA; ++l) As[threadIdx.x + l * kStreamBlock] = va[l];
#pragma unroll
        for (int l = 0; l < LB; ++l) Bs[threadIdx.x + l * kStreamBlock] = vb[l];
        __syncthreads();
        if (k0 + kGK < K) fetch(k0 + kGK);
#pragma unroll
        for (int k = 0; k < kGK; ++k) {
          const float4 a0 = *reinterpret_cast<const float4*>(As + k * kGM + ty * 8);
          const float4 a1 = *reinterpret_cast<const float4*>(As + k * kGM + ty * 8 + 4);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          float bv[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) bv[c] = Bs[k * BN + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
        }
      }
      __syncthreads();  // the last chunk's readers and the previous tile's end are done
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) Cs[(ty * 8 + i) * BN + tx + 16 * c] = acc[i][c];
      __syncthreads();
      end(m0, n0, mn, nn, BN);
    }
  }
  __syncthreads();
}

// The columns a thread of the tile GEMM keeps for N output columns: 4, 6 or
// 8, the one that leaves the fewest idle columns (the larger on a tie).
__device__ inline int gemm_nc(int N) {
  int best = 8, waste = (N + 127) / 128 * 128 - N;
  for (int nc = 6; nc >= 4; nc -= 2) {
    const int w = (N + 16 * nc - 1) / (16 * nc) * 16 * nc - N;
    if (w < waste) best = nc, waste = w;
  }
  return best;
}

// The tile GEMM with the columns a thread keeps chosen for N, its buffers
// (kGK, kGM), (kGK, kGN) and the output tile (kGM, kGN) at kWorkOffset.
template <class Start, class FillA, class FillB, class End>
__device__ void tile_gemm_any(int M, int N, int K, const Start& start, const FillA& fill_a, const FillB& fill_b,
                              const End& end) {
  extern __shared__ __align__(16) float smem[];
  float* const As = smem + kWorkOffset;
  float* const Bs = As + kGK * kGM;
  float* const Cs = Bs + kGK * kGN;
  switch (gemm_nc(N)) {
    case 4: tile_gemm<4>(M, N, K, As, Bs, Cs, start, fill_a, fill_b, end); break;
    case 6: tile_gemm<6>(M, N, K, As, Bs, Cs, start, fill_a, fill_b, end); break;
    default: tile_gemm<8>(M, N, K, As, Bs, Cs, start, fill_a, fill_b, end); break;
  }
}

// The stage's two basis-row products, each in a function of its own (its
// own register allocation).  Basis row m = j T + t of the tile; W1C holds
// the rows W1[j, :] of a block tile's j.  tile_gemm's output tile Cs is at
// kWorkOffset + kGK (kGM + kGN).

// The rows of m: m[(j, t), i] = sum_h (dh_t (.) W1[j, :])_h W2[h, i]; each
// block tile's m goes to the factor scratch ctm ((dz^2, B), sample-minor),
// and each (t, i) adds the tile's rows' m[j, i]^2 to S in j order (D[t, i]
// = m[i, i]).
__device__ __noinline__ void m_rows(const float* w1, const float* w2, const float* DH, float* W1C, float* S, float* D,
                                    float* ctm, int B, int s0, int nv, int T, int lgT, int dz, int H, int hp, int zp) {
  extern __shared__ __align__(16) float smem[];
  const float* const Cs = smem + kWorkOffset + kGK * kGM + kGK * kGN;
  int jbase = 0;
  auto load_w1 = [&](int m0, int mn) {
    jbase = m0 >> lgT;
    const int nj = mn >> lgT;
    for (int idx = threadIdx.x; idx < nj * H; idx += blockDim.x) {
      const int jj = idx / H, o = idx % H;
      W1C[jj * hp + o] = __ldg(w1 + (size_t)(jbase + jj) * H + o);
    }
  };
  tile_gemm_any(
      T * dz, dz, H, load_w1,
      [&](int m, int h) { return DH[(m & (T - 1)) * hp + h] * W1C[((m >> lgT) - jbase) * hp + h]; },
      [&](int h, int i) { return __ldg(w2 + (size_t)h * dz + i); },
      [&](int m0, int n0, int mn, int nn, int pitch) {
        const int nj = mn >> lgT, j0 = m0 >> lgT;
        for (int idx = threadIdx.x; idx < nj * nn * T; idx += blockDim.x) {
          const int t = idx & (T - 1), r = idx >> lgT, ii = r % nn, jj = r / nn;
          if (t < nv) ctm[((size_t)(j0 + jj) * dz + n0 + ii) * B + s0 + t] = Cs[(jj * T + t) * pitch + ii];
        }
        for (int idx = threadIdx.x; idx < T * nn; idx += blockDim.x) {
          const int ii = idx % nn, t = idx / nn, i = n0 + ii;
          float sv = S[t * zp + i];
          for (int jj = 0; jj < nj; ++jj) {
            const float x = Cs[(jj * T + t) * pitch + ii];
            sv = fmaf(x, x, sv);
            if (j0 + jj == i) D[t * zp + i] = x;
          }
          S[t * zp + i] = sv;
        }
      });
}

// ct_m = [i = j] ct_d + 2 ct_s m over m in ctm, in place (a warp's lanes
// over a row's samples, kBatch of a thread's loads in flight at once), with
// ct_d and ct_s in D and S; then ct_dh[t, h] = sum_j W1[j, h] sum_i
// ct_m[(j, t), i] W2[h, i] into CA: the tile GEMM over the basis rows and
// W2^T, each (t, h) adding the block tile's rows times W1[j, h] in j order.
__device__ __noinline__ void ct_m_push(const float* w1, const float* w2t, const float* D, const float* S,
                                       float* W1C, float* CA, float* ctm, int B, int s0, int nv, int T, int lgT, int dz,
                                       int H, int hp, int zp) {
  extern __shared__ __align__(16) float smem[];
  const float* const Cs = smem + kWorkOffset + kGK * kGM + kGK * kGN;
  constexpr int kBatch = 8;
  const int nct = dz * dz * T;
  for (int base = threadIdx.x; base < nct; base += kBatch * blockDim.x) {
    float mv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x, t = idx & (T - 1), r = idx >> lgT;
      mv[u] = idx < nct && t < nv ? ctm[(size_t)r * B + s0 + t] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x, t = idx & (T - 1), r = idx >> lgT, i = r % dz, j = r / dz;
      if (idx < nct && t < nv)
        ctm[(size_t)r * B + s0 + t] = (i == j ? D[t * zp + i] : 0.f) + (2.f * S[t * zp + i]) * mv[u];
    }
  }
  int jbase = 0;
  auto load_w1 = [&](int m0, int mn) {
    jbase = m0 >> lgT;
    const int nj = mn >> lgT;
    for (int idx = threadIdx.x; idx < nj * H; idx += blockDim.x) {
      const int jj = idx / H, o = idx % H;
      W1C[jj * hp + o] = __ldg(w1 + (size_t)(jbase + jj) * H + o);
    }
  };
  tile_gemm_any(
      T * dz, H, dz, load_w1,
      [&](int m, int i) {
        const int t = m & (T - 1);
        return t < nv ? ctm[((size_t)(m >> lgT) * dz + i) * B + s0 + t] : 0.f;
      },
      [&](int i, int h) { return __ldcg(w2t + (size_t)i * H + h); },
      [&](int m0, int n0, int mn, int nn, int pitch) {
        const int nj = mn >> lgT;
        for (int idx = threadIdx.x; idx < T * nn; idx += blockDim.x) {
          const int hh = idx % nn, t = idx / nn, h = n0 + hh;
          float v = CA[t * hp + h];
          for (int jj = 0; jj < nj; ++jj) v += Cs[(jj * T + t) * pitch + hh] * W1C[jj * hp + h];
          CA[t * hp + h] = v;
        }
      });
}

// One augmented stage of a tile (fused_solve.py::_stage_train_exact_fwdbwd
// with ct_y = a_z, ct_r = a_acc): KZ = y, KR = the rates, KAZ = -ct_z, and
// the tile's factors of the gradient rate in the global scratch.  The basis
// rows (j, t) of the tile run j-major (row j T + t), so the 8 rows a thread
// of the tile GEMM keeps are consecutive samples of one j, and a block
// tile's kGM rows are kGM / T whole j.
struct StreamExactAdjStage {
  const StreamLayout* L;
  const float* params;
  const float* w2t;    // (dz, H): W2^T
  const float* aaccT;  // (3, B)
  Factors f;
  TileArrays a;
  float* wc;           // the chunk buffer
  int B, T, lgT, norm_z, norm_j;

  // Not inlined: the stage's products get the registers the solver's
  // long-lived state would otherwise take from them.
  __device__ __noinline__ void operator()(int s0, int nv, const float* Z, const float* AZ, float* KZ, float* KR,
                                          float* KAZ) const {
    run<false>(s0, nv, Z, AZ, KZ, KR, KAZ, nullptr, nullptr, nullptr);
  }

  // The stage; COND (the COND instance, K8): the forward adds W1's ys rows
  // times the tile's ys rows YS (T, nc), loaded from ys (B, nc), to h's
  // pre-activation, and k_ays = -(W1's ys rows ct_pre1) goes to KYS (T, nc),
  // from one transposed product over W1's dz + nc rows with k_az.  The m
  // rows, the ct_m push and g_pm read W1's z rows alone (the Jacobian is in
  // z).
  template <bool COND>
  __device__ __forceinline__ void run(int s0, int nv, const float* Z, const float* AZ, float* KZ, float* KR,
                                      float* KAZ, [[maybe_unused]] const float* ys, [[maybe_unused]] float* YS,
                                      [[maybe_unused]] float* KYS) const {
    // The members as locals: `this` points into local memory, which the
    // loops would otherwise reread.
    const StreamLayout& c = *L;
    const TileArrays a = this->a;
    const Factors f = this->f;
    const float* const w2t = this->w2t;
    const float* const aaccT = this->aaccT;
    float* const wc = this->wc;
    const int B = this->B, T = this->T, lgT = this->lgT, norm_z = this->norm_z, norm_j = this->norm_j;
    const int dz = c.dz, zp = c.zp, H = c.width[1], hp = c.hp[1];
    const float* w1 = cnf::layer_w(c, params, 0);
    const float* w2 = cnf::layer_w(c, params, 1);
    if constexpr (COND) {
      cnf::load_tile_cond(ys, cnf::stream_nc(c), s0, nv, T, YS);
      cnf::stream_two_layer_forward<true>(c, params, Z, T, a.HS, a.DH, KZ, a.DY, wc, YS);
    } else {
      cnf::stream_two_layer_forward(c, params, Z, T, a.HS, a.DH, KZ, a.DY, wc);
    }
    for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
      const int t = idx / dz, i = idx % dz;
      a.S[t * zp + i] = 0.f;
    }
    __syncthreads();
    // The rows of m, their j-order sums s and d (both zeroed first).
    m_rows(w1, w2, a.DH, a.W1C, a.S, a.D, f.ctm, B, s0, nv, T, lgT, dz, H, hp, zp);
    // The rates and their cotangent factors.
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float ysq = 0.f, tr = 0.f, fro2 = 0.f;
      for (int k = 0; k < dz; ++k) {
        const int o = t * zp + k;
        const float y = KZ[o], dy = a.DY[o];
        ysq = fmaf(y, y, ysq);
        tr = fmaf(dy, a.D[o], tr);
        fro2 = fmaf(dy * dy, a.S[o], fro2);
      }
      const float e_rate = safe_norm_sq(ysq), n_rate = safe_norm_sq(fro2);
      KR[t * 3 + 0] = -tr;
      KR[t * 3 + 1] = norm_z ? e_rate : 0.f;
      KR[t * 3 + 2] = norm_j ? n_rate : 0.f;
      float aacc[3];
      for (int r = 0; r < 3; ++r) aacc[r] = t < nv ? aaccT[(size_t)r * B + s0 + t] : 0.f;
      a.SC[t * 4 + 0] = -aacc[0];  // ct_tr: the rate is -tr
      a.SC[t * 4 + 1] = norm_j ? 0.5f * ct_safe_norm(aacc[2], n_rate) : 0.f;  // n = sqrt(fro^2)
      a.SC[t * 4 + 2] = norm_z ? ct_safe_norm(aacc[1], e_rate) : 0.f;
    }
    __syncthreads();
    // ct_d, ct_s over d, s; ct_pre2 = (a_z - 2 y ct_dy + y fz) dy.
    for (int idx = threadIdx.x; idx < T * dz; idx += blockDim.x) {
      const int t = idx / dz, k = idx % dz, o = t * zp + k;
      const float ct_tr = a.SC[t * 4], ct_fro2 = a.SC[t * 4 + 1], fz = a.SC[t * 4 + 2];
      const float dy = a.DY[o], y = KZ[o];
      float ct_dy = a.D[o] * ct_tr;
      if (norm_j) ct_dy = ct_dy + 2.f * dy * a.S[o] * ct_fro2;
      float ct_y = AZ[o] + (-2.f * y) * ct_dy;
      if (norm_z) ct_y = ct_y + y * fz;
      a.CP2[o] = ct_y * dy;
      a.D[o] = dy * ct_tr;
      a.S[o] = (dy * dy) * ct_fro2;
    }
    for (int idx = threadIdx.x; idx < T * H; idx += blockDim.x) {
      const int t = idx / H, o = idx % H;
      a.CA[t * hp + o] = 0.f;
    }
    __syncthreads();
    // ct_m over m, and ct_dh into CA (zeroed first).
    ct_m_push(w1, w2t, a.D, a.S, a.W1C, a.CA, f.ctm, B, s0, nv, T, lgT, dz, H, hp, zp);
    // Down the forward chain: ct_pre1 = (W2 ct_pre2 - 2 h ct_dh) dh over
    // ct_dh, k_az = -W1 ct_pre1 (and, COND, k_ays over W1's ys rows).
    cnf::stream_mm_t(a.CP2, zp, dz, w2, H, T, wc, [&](int t, int o, float x) {
      const int i = t * hp + o;
      a.CA[i] = (x + (-2.f * a.HS[i]) * a.CA[i]) * a.DH[i];
    });
    if constexpr (COND) {
      const int nc = cnf::stream_nc(c);
      cnf::stream_mm_t(a.CA, hp, H, w1, dz + nc, T, wc, [&](int t, int k, float x) {
        if (k < dz)
          KAZ[t * zp + k] = -x;
        else
          KYS[t * nc + k - dz] = -x;
      });
    } else {
      cnf::stream_mm_t(a.CA, hp, H, w1, dz, T, wc, [&](int t, int k, float x) { KAZ[t * zp + k] = -x; });
    }
    // The tile's factors of the gradient rate, a warp's lanes over samples.
    for (int idx = threadIdx.x; idx < H * T; idx += blockDim.x) {
      const int h = idx / T, t = idx % T;
      if (t < nv) {
        const size_t o = (size_t)h * B + s0 + t;
        f.dh[o] = a.DH[t * hp + h];
        f.cp1[o] = a.CA[t * hp + h];
        f.hx[o] = a.HS[t * hp + h];
      }
    }
    for (int idx = threadIdx.x; idx < dz * T; idx += blockDim.x) {
      const int k = idx / T, t = idx % T;
      if (t < nv) {
        const size_t o = (size_t)k * B + s0 + t;
        f.zx[o] = Z[t * zp + k];
        f.cp2[o] = a.CP2[t * zp + k];
      }
    }
  }
};

// A 4-byte asynchronous copy from global to shared memory, through the L2
// (the factors were written by other blocks before a grid barrier); zero
// bytes read, the destination zero-filled, where `in` is false.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(in ? 4 : 0));
}

// One batch-wide product of the gradient rate: g[off + r cols + c] gets
// -sum_s A[r][s] Bm[c][s] for r < rows, c < cols (A and Bm (., B)).  Its
// columns run in `passes` passes of `width` (a multiple of 32, at most
// kCCols) each.
struct Product {
  const float* A;
  const float* Bm;
  int rows, cols;
  size_t off;
  int passes, width, tasks;
};

__device__ inline Product make_product(const float* A, const float* Bm, int rows, int cols, size_t off) {
  Product p;
  p.A = A;
  p.Bm = Bm;
  p.rows = rows;
  p.cols = cols;
  p.off = off;
  p.passes = (cols + kCCols - 1) / kCCols;
  p.width = cnf::round_up((cols + p.passes - 1) / p.passes, 32);
  p.tasks = (rows + kCRows - 1) / kCRows * p.passes;
  return p;
}

// The three products, g_pm = ct_m^T dh first (the largest), then
// [W1 | b1] = [z | 1]^T ct_pre1 and [W2 | b2] = [h | 1]^T ct_pre2; their
// tasks are numbered in that order, and block b takes tasks b, b + grid, ...
struct Contraction {
  Product p[3];
  int ntasks;

  __device__ Contraction(const StreamLayout& L, const Factors& f) {
    const int dz = L.dz, H = L.width[1];
    p[0] = make_product(f.ctm, f.dh, dz * dz, H, (size_t)L.P);
    p[1] = make_product(f.zx, f.cp1, dz + 1, H, 0);
    p[2] = make_product(f.hx, f.cp2, H + 1, dz, (size_t)L.pofs[1]);
    ntasks = p[0].tasks + p[1].tasks + p[2].tasks;
  }

  // The COND instance's (K8): [W1 | b1] = [z | ys | 1]^T ct_pre1 over W1's
  // dz + nc rows, W1's ys rows summing ys (x) ct_pre1 in the same order.
  __device__ Contraction(const StreamLayout& L, const Factors& f, int nc) : Contraction(L, f) {
    p[1] = make_product(f.zx, f.cp1, L.dz + nc + 1, L.width[1], 0);
    ntasks = p[0].tasks + p[1].tasks + p[2].tasks;
  }

  // Task `task`'s product, its first row and first column, and its rows and
  // columns.
  __device__ const Product& locate(int task, int* r0, int* c0, int* nr, int* nc) const {
    int i = 0;
    while (task >= p[i].tasks) task -= p[i++].tasks;
    const Product& q = p[i];
    *r0 = task / q.passes * kCRows;
    *c0 = task % q.passes * q.width;
    *nr = min(kCRows, q.rows - *r0);
    *nc = min(q.width, q.cols - *c0);
    return q;
  }

  // fn(q) for every g entry q this block owns, the block's threads over them.
  template <class Fn>
  __device__ void owned(const Fn& fn) const {
    for (int task = blockIdx.x; task < ntasks; task += gridDim.x) {
      int r0, c0, nr, nc;
      const Product& q = locate(task, &r0, &c0, &nr, &nc);
      for (int idx = threadIdx.x; idx < nr * nc; idx += blockDim.x)
        fn(q.off + (size_t)(r0 + idx / nc) * q.cols + c0 + idx % nc);
    }
  }

  // apply(q, rate) for every g entry q this block owns, rate the stage's
  // negated g rate summed over the whole batch in sample order.  Each
  // thread keeps 8 rows by NC (the task's width / 32) columns of a task in
  // registers; the next chunk of samples is copied into shared memory
  // (cp.async) while the block computes on the current one.  Not inlined,
  // as the stage.
  template <class Apply>
  __device__ __noinline__ void operator()(int B, const Apply& apply) const {
    for (int task = blockIdx.x; task < ntasks; task += gridDim.x) {
      int r0, c0, nr, nc;
      const Product& q = locate(task, &r0, &c0, &nr, &nc);
      switch (q.width >> 5) {
        case 1: run<1>(q, r0, c0, nr, nc, B, apply); break;
        case 2: run<2>(q, r0, c0, nr, nc, B, apply); break;
        case 3: run<3>(q, r0, c0, nr, nc, B, apply); break;
        case 4: run<4>(q, r0, c0, nr, nc, B, apply); break;
        case 5: run<5>(q, r0, c0, nr, nc, B, apply); break;
        case 6: run<6>(q, r0, c0, nr, nc, B, apply); break;
        case 7: run<7>(q, r0, c0, nr, nc, B, apply); break;
        default: run<8>(q, r0, c0, nr, nc, B, apply); break;
      }
    }
  }

  // One task: rows r0 .. r0 + nr - 1, columns c0 .. c0 + nc - 1 of q; its
  // two chunk buffers (kContractFloats floats) at kWorkOffset.
  template <int NC, class Apply>
  __device__ void run(const Product& q, int r0, int c0, int nr, int nc, int B, const Apply& apply) const {
    extern __shared__ __align__(16) float smem[];
    float* const buf = smem + kWorkOffset;
    const float* const A = q.A;
    const float* const Bm = q.Bm;
    const size_t off = q.off;
    const int cols = q.cols;
    const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
    const int nch = (B + kCS - 1) / kCS;
    float acc[8][NC];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    // Chunk ch into buffer ch & 1: entries past the rows, columns or batch
    // are zero-filled.
    auto issue = [&](int ch) {
      float* As = buf + (ch & 1) * kChunkCFloats;
      float* Bs = As + kCS * kAPitch;
      const int s0 = ch * kCS;
      for (int idx = threadIdx.x; idx < kCRows * kCS; idx += kStreamBlock) {
        const int r = idx / kCS, s = idx % kCS;
        const bool in = r < nr && s0 + s < B;
        copy_async(As + s * kAPitch + r, in ? A + (size_t)(r0 + r) * B + s0 + s : A, in);
      }
      for (int idx = threadIdx.x; idx < 32 * NC * kCS; idx += kStreamBlock) {
        const int col = idx / kCS, s = idx % kCS;
        const bool in = col < nc && s0 + s < B;
        copy_async(Bs + col * kBPitch + s, in ? Bm + (size_t)(c0 + col) * B + s0 + s : Bm, in);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    issue(0);
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch) {
        issue(ch + 1);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      const float* ar = buf + (ch & 1) * kChunkCFloats + ty * 8;
      const float* br = buf + (ch & 1) * kChunkCFloats + kCS * kAPitch + tx * kBPitch;
#pragma unroll 4
      for (int s = 0; s < kCS; ++s) {
        const float4 a0 = *reinterpret_cast<const float4*>(ar + s * kAPitch);
        const float4 a1 = *reinterpret_cast<const float4*>(ar + s * kAPitch + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) bv[c] = br[c * 32 * kBPitch + s];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      }
      __syncthreads();  // the chunk's readers are done before its buffer is refilled
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 32 * c;
        if (r < nr && col < nc) apply(off + (size_t)(r0 + r) * cols + c0 + col, -acc[i][c]);
      }
    }
  }
};

// One block an SM (its shared memory allows no second).
__global__ void __launch_bounds__(kStreamBlock, 1) k4_stream_adjoint(const AdjArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  __shared__ float gtot[2];
  cnf::share_layout(p.L, &L);
  cg::grid_group grid = cg::this_grid();
  const cnf::AdjState& st = p.s;
  const cnf::Tableau& Tb = cnf::share_tableau(st.tab);
  const int S = Tb.S;
  const bool has3 = Tb.has3 != 0;
  const bool fsal = Tb.fsal != 0;
  const int NG = has3 ? 3 : 2;
  const int dz = L.dz, H = L.width[1], B = st.B, G = gridDim.x, T = p.T, zp = L.zp;
  const int ntiles = (B + T - 1) / T;
  const int R = 2 * dz + 3;  // rows: z, acc, a_z
  const size_t RB = (size_t)R * B;
  const size_t Pt = (size_t)L.P + (size_t)dz * dz * H;
  float* Y = st.work;
  float* Yn = Y + RB;
  float* K = Yn + RB;
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  float* scratch = p.tiles ? p.tiles + (size_t)blockIdx.x * region_floats(L, T) : smem + kWorkOffset + kGemmFloats;
  float* Z = scratch;
  float* AZ = Z + T * zp;
  float* KZ = AZ + T * zp;
  float* KAZ = KZ + T * zp;
  float* KR = KAZ + T * zp;
  const Factors f = factors(L, p.fac, B);
  const StreamExactAdjStage stage{&L,     p.params, p.w2t, st.aaccT, f, tile_arrays(L, T, KR + 3 * T), wc, B, T,
                                  __ffs(T) - 1, p.norm_z, p.norm_j};
  const Contraction contract(L, f);
  float* gcur = p.g;
  float* gnew = p.gnew;
  float* GB = p.gvec;
  float* GE = GB + Pt;
  float* GE3 = GE + Pt;
  float* k1p = GB + NG * Pt;  // the owned entries' stage-1 g rate
  float* k7p = k1p + Pt;      // and their last stage's

  // The per-sample pass of stage stg (stg = 0: at Y) over the block's tiles
  // into the plane K[stg] and the factor scratch.
  auto pass = [&](int stg, float dt_use) {
    for (int tile = blockIdx.x; tile < ntiles; tile += G) {
      const int s0 = tile * T, nv = min(T, B - s0);
      cnf::tile_stage_input<kStageUnroll>(Tb, stg, dt_use, Y, K, RB, B, 0, dz, s0, nv, T, Z, zp);
      cnf::tile_stage_input<kStageUnroll>(Tb, stg, dt_use, Y, K, RB, B, dz + 3, dz, s0, nv, T, AZ, zp);
      __syncthreads();
      stage(s0, nv, Z, AZ, KZ, KR, KAZ);
      float* kst = K + stg * RB;
      cnf::tile_store(KZ, zp, dz, kst, 0, B, s0, nv, T);
      cnf::tile_store(KR, 3, 3, kst, dz, B, s0, nv, T);
      cnf::tile_store(KAZ, zp, dz, kst, dz + 3, B, s0, nv, T);
      __syncthreads();
    }
  };
  // Stage 1 at the current state, the owned entries' g rate into k1p.
  auto stage1 = [&]() {
    pass(0, 0.f);
    grid.sync();
    contract(B, [&](size_t q, float v) { k1p[q] = v; });
    grid.sync();
  };

  for (int tile = blockIdx.x; tile < ntiles; tile += G) {
    cnf::tile_entries(tile, T, B, R, [&](int r, int s) {
      Y[(size_t)r * B + s] = r < dz       ? st.zT[(size_t)s * dz + r]
                             : r < dz + 3 ? st.accT[(size_t)(r - dz) * B + s]
                                          : st.azT[(size_t)s * dz + r - dz - 3];
    });
  }
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < B; s += G * blockDim.x) {
    f.zx[(size_t)dz * B + s] = 1.f;
    f.hx[(size_t)H * B + s] = 1.f;
  }
  const float* w2 = cnf::layer_w(L, p.params, 1);
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < dz * H; idx += G * blockDim.x) {
    const int i = idx / H, h = idx % H;
    p.w2t[idx] = __ldg(w2 + (size_t)h * dz + i);
  }
  contract.owned([&](size_t q) { gcur[q] = 0.f; });
  grid.sync();  // W2^T, read by every block's stages
  stage1();

  cnf::Controller c;
  c.init(st.ts, st.beta1, st.beta2, st.inv_order);
  const float n_elems = (float)B * (float)(2 * (dz + 3)) + (float)Pt;

  while (c.running(st.max_steps)) {
    bool is_last;
    const float dt_use = c.plan(&is_last);
    const int par = c.steps & 1;
    const float cb0 = dt_use * Tb.b[0], ce0 = dt_use * Tb.btilde[0], ce30 = dt_use * Tb.btilde3[0];
    contract.owned([&](size_t q) {
      const float k = k1p[q];
      GB[q] = cb0 * k;
      GE[q] = ce0 * k;
      if (has3) GE3[q] = ce30 * k;
    });
#pragma unroll 1
    for (int stg = 1; stg < S; ++stg) {
      pass(stg, dt_use);
      grid.sync();
      const float bs = Tb.b[stg], bt = Tb.btilde[stg], bt3 = Tb.btilde3[stg];
      const float cb = dt_use * bs, ce = dt_use * bt, ce3 = dt_use * bt3;
      const bool last = fsal && stg == S - 1;
      contract(B, [&](size_t q, float v) {
        if (bs != 0.f) GB[q] = fmaf(cb, v, GB[q]);
        if (bt != 0.f) GE[q] = fmaf(ce, v, GE[q]);
        if (has3 && bt3 != 0.f) GE3[q] = fmaf(ce3, v, GE3[q]);
        if (last) k7p[q] = v;
      });
      // The next stage's pass rewrites the factors: every block must be done
      // reading them.  (After the last stage the error barrier does it.)
      if (stg < S - 1) grid.sync();
    }
    __syncthreads();

    // The proposals and errors: the tiles' z, acc and a_z rows (a_acc is
    // constant: zero error, but counted in n_elems), then the owned g.
    float sumsq = 0.f, sumsq3 = 0.f;
    bool finite = true;
    for (int tile = blockIdx.x; tile < ntiles; tile += G) {
      cnf::tile_entries(tile, T, B, R, [&](int r, int s) {
        const float yn = cnf::propose<kStageUnroll>(Tb, dt_use, has3, Y, K, RB, (size_t)r * B + s, st.rtol, st.atol,
                                                    Yn, &sumsq, &sumsq3);
        if (r < dz || r >= dz + 3) finite = finite && isfinite(yn);
      });
    }
    float gsq = 0.f, gsq3 = 0.f;
    contract.owned([&](size_t q) {
      const float g0 = gcur[q], gn = g0 + GB[q];
      gnew[q] = gn;
      const float sc = st.atol + st.rtol * fmaxf(fabsf(g0), fabsf(gn));
      const float e = GE[q] / sc;
      gsq = fmaf(e, e, gsq);
      if (has3) {
        const float e3 = GE3[q] / sc;
        gsq3 = fmaf(e3, e3, gsq3);
      }
    });
    float* slots = st.partials + (size_t)(5 * par) * G;
    cnf::write_block_partial(sumsq, sumsq3, has3, finite, slots, 0, red);
    gsq = cnf::block_sum(gsq, red);
    if (has3) gsq3 = cnf::block_sum(gsq3, red);
    if (threadIdx.x == 0) {
      slots[3 * G + blockIdx.x] = gsq;
      slots[4 * G + blockIdx.x] = gsq3;
    }
    grid.sync();
    float total, total3;
    bool all_finite;
    cnf::read_grid_total(slots, 0, has3, red, &total, &total3, &all_finite);
    if (threadIdx.x == 0) {
      float tg = 0.f, tg3 = 0.f;
      for (int b = 0; b < G; ++b) tg += __ldcg(slots + 3 * G + b);
      if (has3)
        for (int b = 0; b < G; ++b) tg3 += __ldcg(slots + 4 * G + b);
      gtot[0] = tg;
      gtot[1] = tg3;
    }
    __syncthreads();
    float eest = sqrtf((total + gtot[0]) / n_elems);
    if (has3) eest = cnf::stretched_eest(eest, sqrtf((total3 + gtot[1]) / n_elems));
    __syncthreads();
    if (c.update(eest, all_finite, dt_use, is_last)) {
      for (int tile = blockIdx.x; tile < ntiles; tile += G) {
        cnf::tile_entries(tile, T, B, R, [&](int r, int s) {
          const size_t off = (size_t)r * B + s;
          Y[off] = Yn[off];
          if (fsal) K[off] = K[(S - 1) * RB + off];
        });
      }
      contract.owned([&](size_t q) { gcur[q] = gnew[q]; });
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

  for (int tile = blockIdx.x; tile < ntiles; tile += G) {
    cnf::tile_entries(tile, T, B, R, [&](int r, int s) {
      const float v = Y[(size_t)r * B + s];
      if (r < dz)
        st.z0[(size_t)s * dz + r] = v;
      else if (r < dz + 3)
        st.acc0[(size_t)(r - dz) * B + s] = v;
      else
        st.az0[(size_t)s * dz + r - dz - 3] = v;
    });
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    st.stats[0] = c.steps;
    st.stats[1] = c.accepted;
  }
}

// The COND instance's factors: zx is (dz + nc + 1, B), [z | ys | 1] (the ys
// rows written once per launch), and the factors after it move down.
__device__ inline Factors cond_factors(const StreamLayout& L, float* base, int B) {
  Factors f = factors(L, base, B);
  const size_t shift = (size_t)cnf::stream_nc(L) * B;
  f.hx += shift;
  f.cp2 += shift;
  return f;
}

// The COND instance's stage: the stage's COND form behind a call of its own,
// its conditioning and k_ays as members.
struct StreamExactCondAdjStage : StreamExactAdjStage {
  const float* ys;  // (B, nc)
  float* YS;        // (T, nc): the tile's ys rows
  float* KYS;       // (T, nc): k_ays

  __device__ __noinline__ void operator()(int s0, int nv, const float* Z, const float* AZ, float* KZ, float* KR,
                                          float* KAZ) const {
    run<true>(s0, nv, Z, AZ, KZ, KR, KAZ, ys, YS, KYS);
  }
};

// The COND instance's arguments: the unconditional instance's (with nc and
// ays0 set in the AdjState) and the conditioning ys (B, nc).
struct CondAdjArgs {
  AdjArgs a;
  const float* ys;
};

// The COND instance's tile arrays: the solver's Z, AZ, KZ, KAZ, KR and
// k_ays (T, nc), then the stage's tile arrays, then the tile's ys rows
// (T, nc), in shared memory or in the block's slice of the global scratch
// alike.
__host__ __device__ inline size_t cond_region_floats(const StreamLayout& L, int T) {
  return region_floats(L, T) + (size_t)2 * T * cnf::stream_nc(L);
}

// The COND instance (K8): k4_stream_adjoint for a conditional net whose W1
// reads [z | ys], with the per-sample a_ys block of the JAX package's
// adjoint kernel (fused_solve.py::_make_adjoint_kernel: k_ays = -ct_zin[dz:]
// :1167, a_ys from 0 at t_hi :1183, combined like a_z, in the one
// batch-global norm :1270, n_elems :1694, a_ys0 returned): the per-sample
// rows are z, acc, a_z and a_ys (2 dz + 3 + nc); a_ys's rows ride in the
// (row, B) planes after a_z but are never staged back into the stage's
// input (its rate does not read it).  The gradient gains W1's ys rows
// through the [W1 | b1] contraction's dz + nc rows; g_pm stays over W1's z
// rows.  One block an SM, as the unconditional instance.
__global__ void __launch_bounds__(kStreamBlock, 1) k4_stream_cond_adjoint(const __grid_constant__ CondAdjArgs ca) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StreamLayout L;
  __shared__ float gtot[2];
  const AdjArgs& p = ca.a;
  cnf::share_layout(p.L, &L);
  cg::grid_group grid = cg::this_grid();
  const cnf::AdjState& st = p.s;
  const cnf::Tableau& Tb = cnf::share_tableau(st.tab);
  const int S = Tb.S;
  const bool has3 = Tb.has3 != 0;
  const bool fsal = Tb.fsal != 0;
  const int NG = has3 ? 3 : 2;
  const int dz = L.dz, H = L.width[1], B = st.B, G = gridDim.x, T = p.T, zp = L.zp, nc = cnf::stream_nc(L);
  const int ntiles = (B + T - 1) / T;
  const int R = 2 * dz + 3 + nc;  // rows: z, acc, a_z, a_ys
  const size_t RB = (size_t)R * B;
  const size_t Pt = (size_t)L.P + (size_t)dz * dz * H;
  float* Y = st.work;
  float* Yn = Y + RB;
  float* K = Yn + RB;
  float* wc = smem;
  float* red = wc + cnf::kChunkFloats;
  float* scratch =
      p.tiles ? p.tiles + (size_t)blockIdx.x * cond_region_floats(L, T) : smem + kWorkOffset + kGemmFloats;
  float* Z = scratch;
  float* AZ = Z + T * zp;
  float* KZ = AZ + T * zp;
  float* KAZ = KZ + T * zp;
  float* KR = KAZ + T * zp;
  float* KYS = KR + 3 * T;
  const TileArrays arrays = tile_arrays(L, T, KYS + T * nc);
  float* YS = arrays.W1C + (size_t)(kGM / T) * L.hp[1];
  const Factors f = cond_factors(L, p.fac, B);
  const StreamExactCondAdjStage stage{{&L, p.params, p.w2t, st.aaccT, f, arrays, wc, B, T, __ffs(T) - 1, p.norm_z,
                                       p.norm_j},
                                      ca.ys,
                                      YS,
                                      KYS};
  const Contraction contract(L, f, nc);
  float* gcur = p.g;
  float* gnew = p.gnew;
  float* GB = p.gvec;
  float* GE = GB + Pt;
  float* GE3 = GE + Pt;
  float* k1p = GB + NG * Pt;  // the owned entries' stage-1 g rate
  float* k7p = k1p + Pt;      // and their last stage's

  // The per-sample pass of stage stg (stg = 0: at Y) over the block's tiles
  // into the plane K[stg] and the factor scratch.
  auto pass = [&](int stg, float dt_use) {
    for (int tile = blockIdx.x; tile < ntiles; tile += G) {
      const int s0 = tile * T, nv = min(T, B - s0);
      cnf::tile_stage_input<kStageUnroll>(Tb, stg, dt_use, Y, K, RB, B, 0, dz, s0, nv, T, Z, zp);
      cnf::tile_stage_input<kStageUnroll>(Tb, stg, dt_use, Y, K, RB, B, dz + 3, dz, s0, nv, T, AZ, zp);
      __syncthreads();
      stage(s0, nv, Z, AZ, KZ, KR, KAZ);
      float* kst = K + stg * RB;
      cnf::tile_store(KZ, zp, dz, kst, 0, B, s0, nv, T);
      cnf::tile_store(KR, 3, 3, kst, dz, B, s0, nv, T);
      cnf::tile_store(KAZ, zp, dz, kst, dz + 3, B, s0, nv, T);
      cnf::tile_store(KYS, nc, nc, kst, 2 * dz + 3, B, s0, nv, T);
      __syncthreads();
    }
  };
  // Stage 1 at the current state, the owned entries' g rate into k1p.
  auto stage1 = [&]() {
    pass(0, 0.f);
    grid.sync();
    contract(B, [&](size_t q, float v) { k1p[q] = v; });
    grid.sync();
  };

  for (int tile = blockIdx.x; tile < ntiles; tile += G) {
    cnf::tile_entries(tile, T, B, R, [&](int r, int s) {
      Y[(size_t)r * B + s] = r < dz           ? st.zT[(size_t)s * dz + r]
                             : r < dz + 3     ? st.accT[(size_t)(r - dz) * B + s]
                             : r < 2 * dz + 3 ? st.azT[(size_t)s * dz + r - dz - 3]
                                              : 0.f;
    });
  }
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < B; s += G * blockDim.x) {
    for (int c = 0; c < nc; ++c) f.zx[(size_t)(dz + c) * B + s] = ca.ys[(size_t)s * nc + c];
    f.zx[(size_t)(dz + nc) * B + s] = 1.f;
    f.hx[(size_t)H * B + s] = 1.f;
  }
  const float* w2 = cnf::layer_w(L, p.params, 1);
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < dz * H; idx += G * blockDim.x) {
    const int i = idx / H, h = idx % H;
    p.w2t[idx] = __ldg(w2 + (size_t)h * dz + i);
  }
  contract.owned([&](size_t q) { gcur[q] = 0.f; });
  grid.sync();  // W2^T, read by every block's stages
  stage1();

  cnf::Controller c;
  c.init(st.ts, st.beta1, st.beta2, st.inv_order);
  const float n_elems = (float)B * (float)(2 * (dz + 3) + nc) + (float)Pt;

  while (c.running(st.max_steps)) {
    bool is_last;
    const float dt_use = c.plan(&is_last);
    const int par = c.steps & 1;
    const float cb0 = dt_use * Tb.b[0], ce0 = dt_use * Tb.btilde[0], ce30 = dt_use * Tb.btilde3[0];
    contract.owned([&](size_t q) {
      const float k = k1p[q];
      GB[q] = cb0 * k;
      GE[q] = ce0 * k;
      if (has3) GE3[q] = ce30 * k;
    });
#pragma unroll 1
    for (int stg = 1; stg < S; ++stg) {
      pass(stg, dt_use);
      grid.sync();
      const float bs = Tb.b[stg], bt = Tb.btilde[stg], bt3 = Tb.btilde3[stg];
      const float cb = dt_use * bs, ce = dt_use * bt, ce3 = dt_use * bt3;
      const bool last = fsal && stg == S - 1;
      contract(B, [&](size_t q, float v) {
        if (bs != 0.f) GB[q] = fmaf(cb, v, GB[q]);
        if (bt != 0.f) GE[q] = fmaf(ce, v, GE[q]);
        if (has3 && bt3 != 0.f) GE3[q] = fmaf(ce3, v, GE3[q]);
        if (last) k7p[q] = v;
      });
      if (stg < S - 1) grid.sync();
    }
    __syncthreads();

    // The proposals and errors: the tiles' z, acc, a_z and a_ys rows (a_acc
    // is constant: zero error, but counted in n_elems), then the owned g.
    float sumsq = 0.f, sumsq3 = 0.f;
    bool finite = true;
    for (int tile = blockIdx.x; tile < ntiles; tile += G) {
      cnf::tile_entries(tile, T, B, R, [&](int r, int s) {
        const float yn = cnf::propose<kStageUnroll>(Tb, dt_use, has3, Y, K, RB, (size_t)r * B + s, st.rtol, st.atol,
                                                    Yn, &sumsq, &sumsq3);
        if (r < dz || r >= dz + 3) finite = finite && isfinite(yn);
      });
    }
    float gsq = 0.f, gsq3 = 0.f;
    contract.owned([&](size_t q) {
      const float g0 = gcur[q], gn = g0 + GB[q];
      gnew[q] = gn;
      const float sc = st.atol + st.rtol * fmaxf(fabsf(g0), fabsf(gn));
      const float e = GE[q] / sc;
      gsq = fmaf(e, e, gsq);
      if (has3) {
        const float e3 = GE3[q] / sc;
        gsq3 = fmaf(e3, e3, gsq3);
      }
    });
    float* slots = st.partials + (size_t)(5 * par) * G;
    cnf::write_block_partial(sumsq, sumsq3, has3, finite, slots, 0, red);
    gsq = cnf::block_sum(gsq, red);
    if (has3) gsq3 = cnf::block_sum(gsq3, red);
    if (threadIdx.x == 0) {
      slots[3 * G + blockIdx.x] = gsq;
      slots[4 * G + blockIdx.x] = gsq3;
    }
    grid.sync();
    float total, total3;
    bool all_finite;
    cnf::read_grid_total(slots, 0, has3, red, &total, &total3, &all_finite);
    if (threadIdx.x == 0) {
      float tg = 0.f, tg3 = 0.f;
      for (int b = 0; b < G; ++b) tg += __ldcg(slots + 3 * G + b);
      if (has3)
        for (int b = 0; b < G; ++b) tg3 += __ldcg(slots + 4 * G + b);
      gtot[0] = tg;
      gtot[1] = tg3;
    }
    __syncthreads();
    float eest = sqrtf((total + gtot[0]) / n_elems);
    if (has3) eest = cnf::stretched_eest(eest, sqrtf((total3 + gtot[1]) / n_elems));
    __syncthreads();
    if (c.update(eest, all_finite, dt_use, is_last)) {
      for (int tile = blockIdx.x; tile < ntiles; tile += G) {
        cnf::tile_entries(tile, T, B, R, [&](int r, int s) {
          const size_t off = (size_t)r * B + s;
          Y[off] = Yn[off];
          if (fsal) K[off] = K[(S - 1) * RB + off];
        });
      }
      contract.owned([&](size_t q) { gcur[q] = gnew[q]; });
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

  for (int tile = blockIdx.x; tile < ntiles; tile += G) {
    cnf::tile_entries(tile, T, B, R, [&](int r, int s) {
      const float v = Y[(size_t)r * B + s];
      if (r < dz)
        st.z0[(size_t)s * dz + r] = v;
      else if (r < dz + 3)
        st.acc0[(size_t)(r - dz) * B + s] = v;
      else if (r < 2 * dz + 3)
        st.az0[(size_t)s * dz + r - dz - 3] = v;
      else
        st.ays0[(size_t)s * nc + r - 2 * dz - 3] = v;
    });
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    st.stats[0] = c.steps;
    st.stats[1] = c.accepted;
  }
}

size_t smem_bytes(const StreamLayout& L, int T, bool global_tiles) {
  const size_t work = kGemmFloats + (global_tiles ? 0 : region_floats(L, T));
  return sizeof(float) * ((size_t)kWorkOffset + (work > kContractFloats ? work : kContractFloats));
}

size_t cond_smem_bytes(const StreamLayout& L, int T, bool global_tiles) {
  const size_t work = kGemmFloats + (global_tiles ? 0 : cond_region_floats(L, T));
  return sizeof(float) * ((size_t)kWorkOffset + (work > kContractFloats ? work : kContractFloats));
}

// Whether the layout's gradient, P + dz^2 H floats, has int offsets.
bool gradient_fits(const StreamLayout& L) {
  return (long long)L.P + (long long)L.dz * L.dz * L.width[1] < (1LL << 31);
}

// The launch shape of the unconditional or (COND) the COND instance.
template <bool COND>
int shape(int n, const int* widths, int B, int* out) {
  StreamLayout L;
  if (B < 1 || n != 2 || !cnf::make_stream_layout(n, widths, &L, COND) || !gradient_fits(L))
    return (int)cudaErrorInvalidValue;
  for (int pass = 0; pass < 2; ++pass) {
    for (int o = 0; o < (pass == 0 ? kOptions : 1); ++o) {
      const size_t smem = COND ? cond_smem_bytes(L, kTiles[o], pass == 1) : smem_bytes(L, kTiles[o], pass == 1);
      int cap = 0;
      const cudaError_t e = COND ? cnf::coop_max_grid(k4_stream_cond_adjoint, smem, kStreamBlock, &cap)
                                 : cnf::coop_max_grid(k4_stream_adjoint, smem, kStreamBlock, &cap);
      if (e == cudaSuccess && cap >= 1) {
        out[0] = kStreamBlock;
        out[1] = cap;
        out[2] = kTiles[o];
        out[3] = (int)smem;
        out[4] = pass == 0 ? 0 : (int)(COND ? cond_region_floats(L, kTiles[o]) : region_floats(L, kTiles[o]));
        return (int)cudaSuccess;
      }
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The launch shape at batch B: out = {threads per block, blocks (every
// co-resident block: the contraction runs on all of them whatever B), samples
// a tile, dynamic shared memory bytes, floats of global tile scratch a block
// (0: the tile arrays are in shared memory)}, the first tile option whose
// tile arrays fit in shared memory beside the chunk buffer, else the first
// with them in a global scratch.  widths: the 3 level widths (host memory).
// Returns a cudaError_t (cudaErrorInvalidValue for a net not covered).
extern "C" int cnf_k4s_shape(int n, const int* widths, int B, int* out) { return shape<false>(n, widths, B, out); }

// params: [W1 | b1 | W2 | b2] flat (device); g: P_total = P + dz^2 H floats,
// [W1 | b1 | W2 | b2 | g_pm]; acts: 3 (both layers tanh); zT, azT, z0, az0:
// (B, dz); accT/aaccT/acc0: (3, B).  work: (S + 2) (2 dz + 3) B floats;
// partials: 10 grid; gvec: (NG + 2) P_total (NG = 3 for a tableau with
// btilde3, else 2); gnew: P_total; fac: B (dz^2 + 3 H + 2 dz + 2) floats;
// tiles: grid x out[4] floats of cnf_k4s_shape, or null when out[4] is 0;
// w2t: dz H floats (W2^T, written by the launch).  tab: kTableauFloats
// floats (read_tableau).  T, grid, block: from cnf_k4s_shape.  Returns the
// launch's cudaError_t.
extern "C" int cnf_k4s_exact_adjoint(const float* params, const float* zT, const float* accT, const float* azT,
                                     const float* aaccT, const float* ts, float* z0, float* acc0, float* az0,
                                     float* g, int* stats, float* work, float* partials, float* gvec, float* gnew,
                                     float* fac, float* tiles, float* w2t, int B, int n, const int* widths,
                                     int acts, int max_steps, int norm_z, int norm_j, float rtol, float atol,
                                     float beta1, float beta2, float inv_order, const float* tab, int T, int grid,
                                     int block, void* stream) {
  AdjArgs a = {};
  if (block != kStreamBlock || grid < 1 || T < 8 || T > kGM || (T & (T - 1)) != 0 || fac == nullptr ||
      w2t == nullptr ||
      !cnf::make_stream_layout(n, widths, &a.L) || !cnf::stream_two_layer_tanh(a.L, acts) || !gradient_fits(a.L))
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.params = params;
  a.g = g;
  a.gnew = gnew;
  a.gvec = gvec;
  a.fac = fac;
  a.tiles = tiles;
  a.w2t = w2t;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  a.T = T;
  return (int)cnf::coop_launch(k4_stream_adjoint, a, grid, block, smem_bytes(a.L, T, tiles != nullptr),
                               (cudaStream_t)stream);
}

// The COND instance's launch shape (K8), as cnf_k4s_shape; widths[0] =
// dz + nc with nc >= 1, out[4] counting the tile's ys rows and k_ays.
extern "C" int cnf_k4sc_shape(int n, const int* widths, int B, int* out) { return shape<true>(n, widths, B, out); }

// The COND instance (K8): as cnf_k4s_exact_adjoint for a conditional net,
// with ys (B, nc) (device) after params and ays0 (B, nc), the cotangent of
// ys at t_lo, after az0; nc = widths[0] - widths[2] >= 1.  g: P_total =
// P + dz^2 H floats with P counting W1's dz + nc rows (g_pm over its z
// rows); work: (S + 2) (2 dz + 3 + nc) B floats; fac: B (dz^2 + 3 H + 2 dz
// + nc + 2) floats; T, grid, block and the tile scratch from cnf_k4sc_shape.
extern "C" int cnf_k4s_cond_exact_adjoint(const float* params, const float* ys, const float* zT, const float* accT,
                                          const float* azT, const float* aaccT, const float* ts, float* z0,
                                          float* acc0, float* az0, float* ays0, float* g, int* stats, float* work,
                                          float* partials, float* gvec, float* gnew, float* fac, float* tiles,
                                          float* w2t, int B, int n, const int* widths, int acts, int max_steps,
                                          int norm_z, int norm_j, float rtol, float atol, float beta1, float beta2,
                                          float inv_order, const float* tab, int T, int grid, int block,
                                          void* stream) {
  CondAdjArgs ca = {};
  AdjArgs& a = ca.a;
  if (block != kStreamBlock || grid < 1 || T < 8 || T > kGM || (T & (T - 1)) != 0 || fac == nullptr ||
      w2t == nullptr || ys == nullptr || ays0 == nullptr || !cnf::make_stream_layout(n, widths, &a.L, true) ||
      !cnf::stream_two_layer_tanh(a.L, acts) || !gradient_fits(a.L))
    return (int)cudaErrorInvalidValue;
  cnf::set_stream_acts(&a.L, acts);
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, widths[n],
                     max_steps, rtol, atol, beta1, beta2, inv_order, tab);
  a.s.nc = cnf::stream_nc(a.L);
  a.s.ays0 = ays0;
  a.params = params;
  a.g = g;
  a.gnew = gnew;
  a.gvec = gvec;
  a.fac = fac;
  a.tiles = tiles;
  a.w2t = w2t;
  a.norm_z = norm_z;
  a.norm_j = norm_j;
  a.T = T;
  ca.ys = ys;
  return (int)cnf::coop_launch(k4_stream_cond_adjoint, ca, grid, block, cond_smem_bytes(a.L, T, tiles != nullptr),
                               (cudaStream_t)stream);
}
