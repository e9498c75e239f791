// bf16 K2: K2's continuous-adjoint (backsolve) backward integration
// (k2_train_adjoint.cu) with the stage matmuls on the tensor cores in bf16,
// for a TRAIN-mode CNF whose field is an unconditional 2-layer tanh MLP of
// state width up to 32 with one Hutchinson VJP probe: the whole adaptive
// solve of (z, acc, a_z, g_p) from t_hi down to t_lo (any embedded explicit
// tableau, K9) in one cooperative launch.
//
// Replaces the TPU kernel built by continuousnf_tpu/ops/fused_solve.py::
// _make_adjoint_kernel (:1064-1343), launched by make_full_solve.adjoint_solve
// (pl.pallas_call at :1767), with the _stage_train_fwdbwd stage (:372-481,
// K = 1, VJP) under ComputeMode.bf16 (:1464-1465): every _mm (:193-225) of
// the stage rounds both operands to bf16 and sums in f32: the forward chain
// and the probe pullback as bf16 K1's, then
//   ct_v0 = bf16(ct_eJ) bf16(W1), ct_u1 = ct_v0 (1 - h^2),
//   ct_v1 = bf16(ct_u1) bf16(W2), ct_a2 = (a_z + y fz - 2 y (ct_v1 eps)) (1 - y^2),
//   ct_a1 = (bf16(ct_a2) bf16(W2)^T - 2 h (ct_v0 u1)) (1 - h^2),
//   ct_z = bf16(ct_a1) bf16(W1)^T;
// and every _mm_cb (:227-243), the weight gradients summed over the batch:
//   g_W1 = sum_s bf16(ct_eJ)^T bf16(v0) + bf16(z)^T bf16(ct_a1),
//   g_W2 = sum_s bf16(ct_u1)^T bf16(v1) + bf16(h)^T bf16(ct_a2),
// with the bias gradients f32 sums (_rowsum).  The gates, norms and their
// cotangent factors, the state, the RK combination, the error norm (which
// covers g_p, as in K2) and the controller stay f32.  The plain twin is
// fused_solve.py::adjoint_train_plain(bf16=True).
//
// Design: adjoint_solve_tiles of solve_common.cuh (the block-cooperative
// backsolve of the wide kernels: each block's b-, btilde- weighted g vectors
// in global memory, one block's slice of g each, the fixed block order of the
// cross-block sum) with a tile of T = blockDim samples.  Each warp takes its
// 32 rows of the tile as two m16 tiles, in four passes over 16-wide hidden
// chunks (forward, pullback, the pullback's VJP, the forward chain's VJP);
// all eight stage products are mma.sync m16n8k16 (mma_bf16.cuh), each
// chunk's accumulators packed in registers into the A fragment of the next
// product.  Per chunk, h and u1 (later the -2 h (ct_v0 u1) term) wait for the
// next pass in private shared-memory slots of the lane that made them.  The
// eight outer-product factors are kept per sample as bf16 rows in shared
// memory (the rounded operands themselves), and after the tile's stage the
// block forms the two weight gradients as mma.sync products over the tile's
// samples: ldmatrix.trans from those rows gives both fragments, 2 T / 16
// products for each 16 x 8 tile of g, the warps taking the tiles in turn;
// the bias gradients are column sums across each warp's lanes (shuffles),
// then over the warps in order.
//
// What bounds it on the H100: latency.  A stage is 8 dz H + 2 (2 dz H)
// multiply-adds a sample at the flagship (the eight products and the two
// outer products); the time goes to the stage loop's block barriers, the
// tile's trips through shared memory, tanh, and the two grid barriers of
// each attempted step, over bf16's inflated step count (PERF.md).

#include "mma_bf16.cuh"

namespace {

constexpr int kStageUnroll = 1;
constexpr int kMaxT = 128;

using cnf::ct_safe_norm;
using cnf::kRedFloats;
using cnf::safe_norm_sq;
namespace bf = cnf::bf16;

struct AdjArgs {
  cnf::AdjState s;
  const float* w1;   // (dz, H)
  const float* b1;   // (H)
  const float* w2;   // (H, dz)
  const float* b2;   // (dz)
  const float* eps;  // (B, dz) the Hutchinson probe
  float* g;          // (P): [W1 | b1 | W2 | b2], the gradient on return
  float* gnew;       // (P)
  float* gblk;       // (grid, (NG + 2) P)
  int H, norm_z, norm_j;
};

// The block's shared memory after the net: the eight factor rows, then f32
// regions, each 16-byte aligned.
struct Layout {
  size_t net, rows_z, rows_h, red, scratch, priv, gbias, gsum, total;
};

template <int DZ>
__host__ __device__ inline Layout layout(int dz, int H, int T) {
  const int HP = bf::round16(H), nw = T / 32, zp = cnf::tile_pitch(dz);
  const size_t P = 2 * (size_t)dz * H + H + dz;
  Layout L;
  L.net = 0;
  L.rows_z = bf::net_bytes<DZ>(H, false);
  L.rows_h = L.rows_z + 4 * 2 * (size_t)T * (DZ + 8);
  L.red = L.rows_h + 4 * 2 * (size_t)T * (HP + 8);
  L.scratch = L.red + 4 * (size_t)kRedFloats;
  L.priv = L.scratch + 4 * (size_t)T * (4 * zp + 3);
  L.gbias = L.priv + 4 * (size_t)2 * nw * 2 * (HP / 16) * 256;
  L.gsum = L.gbias + 4 * (size_t)nw * (HP + DZ);
  L.total = L.gsum + 4 * ((P + 3) / 4 * 4);
  return L;
}

// The augmented stage of a tile (fused_solve.py::_stage_train_fwdbwd with
// ct_y = a_z, ct_r = a_acc): KZ = y, KR = the rates, KAZ = -ct_z, and in
// gsum the tile's sums of the parameter cotangents [W1 | b1 | W2 | b2].
template <int DZ>
struct Stage {
  bf::Net n;
  const float* eps;    // (B, dz)
  const float* aaccT;  // (3, B)
  float* hbuf;         // per warp 2 (HP / 16) 256 floats: the lanes' private h
  float* ubuf;         // the same: u1, then the -2 h (ct_v0 u1) term
  float* gbias;        // per warp HP + DZ floats: the bias cotangents' column sums
  float* gsum;         // (P)
  __nv_bfloat16 *s_ctu, *s_z, *s_v1, *s_ca2;   // (T, DZ + 8): ct_eJ, z, v1, ct_a2 per sample
  __nv_bfloat16 *s_v0, *s_ca1, *s_cu1, *s_h;   // (T, HP + 8): v0, ct_a1, ct_u1, h per sample
  int zp, B, norm_z, norm_j;

  __device__ void operator()(int s0, int nv, const float* Z, const float* AZ, float* KZ, float* KR,
                             float* KAZ) const {
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5, nch = n.HP / 16, dz = n.dz, H = n.H;
    const int PZ = n.PZ, PH = n.PH;
    float* hb = hbuf + (size_t)warp * 2 * nch * 256;
    float* ub = ubuf + (size_t)warp * 2 * nch * 256;
    float* gb1 = gbias + (size_t)warp * (n.HP + DZ);
    float* gb2 = gb1 + n.HP;
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = warp * 32 + mt * 16;
      uint32_t az[DZ / 16][4];
#pragma unroll
      for (int ks = 0; ks < DZ / 16; ++ks) {
        bf::load_a_f32(az[ks], Z, zp, r0, ks * 16, dz);
        bf::store_a(az[ks], s_z, PZ, r0, ks * 16);
      }
      // The samples' probe, a_z and a_acc (zero past the batch: every
      // cotangent of such a row is then zero).
      float e[DZ / 8][4], ay[DZ / 8][4], aacc[2][3];
#pragma unroll
      for (int t = 0; t < DZ / 8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = bf::c_col(t, i), row = r0 + bf::c_row(i);
          const bool in = row < nv && k < dz;
          e[t][i] = in ? eps[(size_t)(s0 + row) * dz + k] : 0.f;
          ay[t][i] = k < dz ? AZ[row * zp + k] : 0.f;
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + bf::c_row(2 * half);
#pragma unroll
        for (int r = 0; r < 3; ++r) aacc[half][r] = row < nv ? aaccT[(size_t)r * B + s0 + row] : 0.f;
      }

      // Forward: h = tanh(z W1 + b1), y = tanh(h W2 + b2).
      float y[DZ / 8][4] = {};
#pragma unroll 1
      for (int c = 0; c < nch; ++c) {
        float a1[2][4], h[2][4];
        bf::chunk_mm<DZ>(a1, az, n.w1t, PZ, c);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            h[t][i] = tanhf(a1[t][i] + n.b1[c * 16 + bf::c_col(t, i)]);
            *bf::priv(hb, nch, mt, c, t * 4 + i) = h[t][i];
          }
        uint32_t ah[4];
        bf::c_to_a(ah, h[0], h[1]);
        bf::store_a(ah, s_h, PH, r0, c * 16);
        bf::chunk_acc<DZ>(y, ah, n.w2t, PH, c);
      }
      float v1[DZ / 8][4], ysq[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < DZ / 8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float yv = tanhf(y[t][i] + n.b2[bf::c_col(t, i)]);
          y[t][i] = yv;
          v1[t][i] = e[t][i] * (1.f - yv * yv);
          ysq[i >> 1] = fmaf(yv, yv, ysq[i >> 1]);
        }
      uint32_t av1[DZ / 16][4];
      bf::vec_to_a<DZ>(av1, v1);
#pragma unroll
      for (int ks = 0; ks < DZ / 16; ++ks) bf::store_a(av1[ks], s_v1, PZ, r0, ks * 16);

      // The probe pullback: u1 = v1 W2^T, v0 = u1 (1 - h^2), eJ = v0 W1^T.
      float eJ[DZ / 8][4] = {};
#pragma unroll 1
      for (int c = 0; c < nch; ++c) {
        float u1[2][4];
        bf::chunk_mm<DZ>(u1, av1, n.w2r, PZ, c);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float hv = *bf::priv(hb, nch, mt, c, t * 4 + i);
            *bf::priv(ub, nch, mt, c, t * 4 + i) = u1[t][i];
            u1[t][i] *= 1.f - hv * hv;
          }
        uint32_t av0[4];
        bf::c_to_a(av0, u1[0], u1[1]);
        bf::store_a(av0, s_v0, PH, r0, c * 16);
        bf::chunk_acc<DZ>(eJ, av0, n.w1r, PH, c);
      }

      // The rates, and the cotangent of eJ: ct_eJ = eps ct_tr + eJ fn.
      float tr[2] = {0.f, 0.f}, nsq[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < DZ / 8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tr[i >> 1] = fmaf(eJ[t][i], e[t][i], tr[i >> 1]);
          nsq[i >> 1] = fmaf(eJ[t][i], eJ[t][i], nsq[i >> 1]);
        }
      float fz[2], fn[2], ct_tr[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float e_rate = safe_norm_sq(bf::quad_sum(ysq[half]));
        const float n_rate = safe_norm_sq(bf::quad_sum(nsq[half]));
        const float trs = bf::quad_sum(tr[half]);
        if ((threadIdx.x & 3) == 0) {
          float* kr = KR + 3 * (r0 + bf::c_row(2 * half));
          kr[0] = -trs;
          kr[1] = norm_z ? e_rate : 0.f;
          kr[2] = norm_j ? n_rate : 0.f;
        }
        ct_tr[half] = -aacc[half][0];
        fz[half] = norm_z ? ct_safe_norm(aacc[half][1], e_rate) : 0.f;
        fn[half] = norm_j ? ct_safe_norm(aacc[half][2], n_rate) : 0.f;
      }
      float cte[DZ / 8][4];
#pragma unroll
      for (int t = 0; t < DZ / 8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) cte[t][i] = fmaf(eJ[t][i], fn[i >> 1], e[t][i] * ct_tr[i >> 1]);
      uint32_t acte[DZ / 16][4];
      bf::vec_to_a<DZ>(acte, cte);
#pragma unroll
      for (int ks = 0; ks < DZ / 16; ++ks) bf::store_a(acte[ks], s_ctu, PZ, r0, ks * 16);

      // Up the pullback chain: ct_v0 = ct_eJ W1, ct_u1 = ct_v0 (1 - h^2),
      // the -2 h (ct_v0 u1) term; ct_v1 = ct_u1 W2.
      float cv1[DZ / 8][4] = {};
#pragma unroll 1
      for (int c = 0; c < nch; ++c) {
        float cv0[2][4];
        bf::chunk_mm<DZ>(cv0, acte, n.w1t, PZ, c);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float hv = *bf::priv(hb, nch, mt, c, t * 4 + i);
            float* u = bf::priv(ub, nch, mt, c, t * 4 + i);
            *u = (-2.f * hv) * (cv0[t][i] * *u);
            cv0[t][i] *= 1.f - hv * hv;
          }
        uint32_t acu[4];
        bf::c_to_a(acu, cv0[0], cv0[1]);
        bf::store_a(acu, s_cu1, PH, r0, c * 16);
        bf::chunk_acc<DZ>(cv1, acu, n.w2t, PH, c);
      }

      // The output layer: ct_a2 = (a_z + y fz - 2 y (ct_v1 eps)) (1 - y^2).
      float ca2[DZ / 8][4];
#pragma unroll
      for (int t = 0; t < DZ / 8; ++t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float yv = y[t][i];
          const float ct_h = fmaf(yv, fz[i >> 1], ay[t][i]) + (-2.f * yv) * (cv1[t][i] * e[t][i]);
          ca2[t][i] = ct_h * (1.f - yv * yv);
          const int k = bf::c_col(t, i);
          if (k < dz) KZ[(r0 + bf::c_row(i)) * zp + k] = yv;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float s = bf::column_sum(ca2[t][i] + ca2[t][i + 2]);
          if (bf::lane_id() < 4) gb2[bf::c_col(t, i)] = mt ? gb2[bf::c_col(t, i)] + s : s;
        }
      }
      uint32_t aca2[DZ / 16][4];
      bf::vec_to_a<DZ>(aca2, ca2);
#pragma unroll
      for (int ks = 0; ks < DZ / 16; ++ks) bf::store_a(aca2[ks], s_ca2, PZ, r0, ks * 16);

      // Down the forward chain: ct_a1 = (ct_a2 W2^T + the pullback term)
      // (1 - h^2), ct_z = ct_a1 W1^T.
      float cz[DZ / 8][4] = {};
#pragma unroll 1
      for (int c = 0; c < nch; ++c) {
        float ca1[2][4];
        bf::chunk_mm<DZ>(ca1, aca2, n.w2r, PZ, c);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float hv = *bf::priv(hb, nch, mt, c, t * 4 + i);
            ca1[t][i] = (ca1[t][i] + *bf::priv(ub, nch, mt, c, t * 4 + i)) * (1.f - hv * hv);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = c * 16 + bf::c_col(t, i);
            const float s = bf::column_sum(ca1[t][i] + ca1[t][i + 2]);
            if (bf::lane_id() < 4) gb1[j] = mt ? gb1[j] + s : s;
          }
        }
        uint32_t aca1[4];
        bf::c_to_a(aca1, ca1[0], ca1[1]);
        bf::store_a(aca1, s_ca1, PH, r0, c * 16);
        bf::chunk_acc<DZ>(cz, aca1, n.w1r, PH, c);
      }
#pragma unroll
      for (int t = 0; t < DZ / 8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = bf::c_col(t, i);
          if (k < dz) KAZ[(r0 + bf::c_row(i)) * zp + k] = -cz[t][i];
        }
    }
    __syncthreads();

    // The tile's weight gradients on the tensor cores, the tile's samples as
    // the contraction: 16 x 8 tiles of g_W1 (dz x H) and g_W2 (H x dz).
    const int T = blockDim.x, nh = n.HP / 8, nz = DZ / 8, tiles1 = (DZ / 16) * nh;
    const int tiles = tiles1 + (n.HP / 16) * nz;
    for (int tile = warp; tile < tiles; tile += nw) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const bool w1 = tile < tiles1;
      const int m0 = (w1 ? tile / nh : (tile - tiles1) / nz) * 16;
      const int n0 = (w1 ? tile % nh : (tile - tiles1) % nz) * 8;
#pragma unroll 1
      for (int k0 = 0; k0 < T; k0 += 16) {
        uint32_t a[4], b[2];
        bf::load_at(a, w1 ? s_ctu : s_cu1, w1 ? PZ : PH, m0, k0);
        bf::load_bt(b, w1 ? s_v0 : s_v1, w1 ? PH : PZ, n0, k0);
        bf::mma(acc, a, b[0], b[1]);
        bf::load_at(a, w1 ? s_z : s_h, w1 ? PZ : PH, m0, k0);
        bf::load_bt(b, w1 ? s_ca1 : s_ca2, w1 ? PH : PZ, n0, k0);
        bf::mma(acc, a, b[0], b[1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + bf::c_row(i), col = n0 + bf::c_col(0, i);
        if (w1 && r < dz && col < H) gsum[r * H + col] = acc[i];
        if (!w1 && r < H && col < dz) gsum[(size_t)dz * H + H + r * dz + col] = acc[i];
      }
    }
    // The bias gradients: the warps' column sums in warp order.
    for (int j = threadIdx.x; j < H; j += T) {
      float s = 0.f;
      for (int w = 0; w < nw; ++w) s += gbias[(size_t)w * (n.HP + DZ) + j];
      gsum[(size_t)dz * H + j] = s;
    }
    for (int k = threadIdx.x; k < dz; k += T) {
      float s = 0.f;
      for (int w = 0; w < nw; ++w) s += gbias[(size_t)w * (n.HP + DZ) + n.HP + k];
      gsum[2 * (size_t)dz * H + H + k] = s;
    }
    __syncthreads();
  }
};

// The tile's negated parameter-gradient rate entry q (the stage leaves the
// tile's sums of the cotangents in gsum; the rate is their negation).
struct Grad {
  const float* gsum;
  __device__ float operator()(int q, int) const { return -gsum[q]; }
};

template <int DZ>
__global__ void __launch_bounds__(kMaxT) k2_bf16_adjoint(const AdjArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, dz = p.s.dz, H = p.H;
  const Layout L = layout<DZ>(dz, H, T);
  const bf::Net n = bf::load_net<DZ>(p.w1, p.b1, p.w2, p.b2, dz, H, false, smem);
  const int PZ = n.PZ, PH = n.PH;
  __nv_bfloat16* rz = reinterpret_cast<__nv_bfloat16*>(smem + L.rows_z);
  __nv_bfloat16* rh = reinterpret_cast<__nv_bfloat16*>(smem + L.rows_h);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  float* priv = reinterpret_cast<float*>(smem + L.priv);
  const size_t zrows = (size_t)T * PZ, hrows = (size_t)T * PH, pw = (size_t)(T / 32) * 2 * (n.HP / 16) * 256;
  Stage<DZ> stage;
  stage.n = n;
  stage.eps = p.eps;
  stage.aaccT = p.s.aaccT;
  stage.hbuf = priv;
  stage.ubuf = priv + pw;
  stage.gbias = reinterpret_cast<float*>(smem + L.gbias);
  stage.gsum = reinterpret_cast<float*>(smem + L.gsum);
  stage.s_ctu = rz;
  stage.s_z = rz + zrows;
  stage.s_v1 = rz + 2 * zrows;
  stage.s_ca2 = rz + 3 * zrows;
  stage.s_v0 = rh;
  stage.s_ca1 = rh + hrows;
  stage.s_cu1 = rh + 2 * hrows;
  stage.s_h = rh + 3 * hrows;
  stage.zp = cnf::tile_pitch(dz);
  stage.B = p.s.B;
  stage.norm_z = p.norm_z;
  stage.norm_j = p.norm_j;
  const Grad grad{stage.gsum};
  const int P = 2 * dz * H + H + dz;
  cnf::adjoint_solve_tiles<kStageUnroll>(p.s, stage, grad, P, T, scratch, p.gblk, p.g, p.gnew, red);
}

}  // namespace

// Dynamic shared memory of one block of `block` threads (bytes), 0 for an
// unsupported dz.
extern "C" long long cnf_k2b_smem_bytes(int dz, int H, int block) {
  switch (bf::padded_dz(dz)) {
    case 16: return (long long)layout<16>(dz, H, block).total;
    case 32: return (long long)layout<32>(dz, H, block).total;
    default: return 0;
  }
}

// Largest co-resident grid for a cooperative launch (0 if none).
extern "C" int cnf_k2b_max_grid(int dz, int H, int block, int* out) {
  if (block > kMaxT || block % 32 != 0) return (int)cudaErrorInvalidValue;
  switch (bf::padded_dz(dz)) {
    case 16: return (int)cnf::coop_max_grid(k2_bf16_adjoint<16>, layout<16>(dz, H, block).total, block, out);
    case 32: return (int)cnf::coop_max_grid(k2_bf16_adjoint<32>, layout<32>(dz, H, block).total, block, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// w1 (dz, H), b1, w2 (H, dz), b2, eps (B, dz), zT/azT/z0/az0 (B, dz),
// accT/aaccT/acc0 (3, B), ts (t_hi, t_lo, dt_init); g, gnew (P = 2 dz H + H +
// dz): [W1 | b1 | W2 | b2], the gradient on return; work (S + 2) (2 dz + 3) B
// floats, partials 10 grid, gblk grid (NG + 2) P (NG = 3 for a tableau with
// btilde3, else 2).  A block is a tile of `block` samples (a multiple of 32,
// at most 128).  Returns the launch's cudaError_t.
extern "C" int cnf_k2b_train_adjoint(const float* w1, const float* b1, const float* w2, const float* b2,
                                     const float* eps, const float* zT, const float* accT, const float* azT,
                                     const float* aaccT, const float* ts, float* z0, float* acc0, float* az0, float* g,
                                     int* stats, float* work, float* partials, float* gblk, float* gnew, int B, int dz,
                                     int H, int max_steps, int norm_z, int norm_j, float rtol, float atol, float beta1,
                                     float beta2, float inv_order, const float* tab, int grid, int block,
                                     void* stream) {
  if (block < 32 || block > kMaxT || block % 32 != 0 || grid < 1 || H < 1) return (int)cudaErrorInvalidValue;
  AdjArgs a = {};
  cnf::set_adj_state(&a.s, zT, accT, azT, aaccT, ts, z0, acc0, az0, stats, work, partials, nullptr, B, dz, max_steps,
                     rtol, atol, beta1, beta2, inv_order, tab);
  a.w1 = w1; a.b1 = b1; a.w2 = w2; a.b2 = b2; a.eps = eps;
  a.g = g; a.gnew = gnew; a.gblk = gblk;
  a.H = H; a.norm_z = norm_z; a.norm_j = norm_j;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bf::padded_dz(dz)) {
    case 16: return (int)cnf::coop_launch(k2_bf16_adjoint<16>, a, grid, block, layout<16>(dz, H, block).total, s);
    case 32: return (int)cnf::coop_launch(k2_bf16_adjoint<32>, a, grid, block, layout<32>(dz, H, block).total, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
