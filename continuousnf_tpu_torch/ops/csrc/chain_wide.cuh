// The wide chain layer of the wide solve kernels (the wide K1 and K2 chain
// forms, the wide K7 TEST and exact forwards): a Dense chain of
// n = 2 .. kMaxLayers tanh or identity layers (ChainLayout::act's mask,
// K9), widths dz + nc -> H1 -> ... -> H(n-1) -> dz with dz <= kWideMaxDz and
// hidden widths <= kWideMaxWidth, evaluated by a whole block for a tile of T
// samples at once (the solves of solve_common.cuh's tile section).  nc is 0
// but for the COND instances (K8: a conditional net's first layer reads
// [z | ys], ys constant over the solve): layer 0 then keeps its nc ys rows
// after its dz z rows in its (dz + nc, pitch) weights, width[0] = dz + nc
// (wide_nc), and a tile's ys values sit in a (T, nc) array beside its
// vectors.  The layout gains no field for them, so the unconditional
// instances' arguments and machine code stay as they were.  Only the
// forward reads the ys rows; the probe pullback and pushforward read layer
// 0's z rows alone (the Jacobian is in z).
//
// Why a tile and not a thread per sample (chain_common.cuh): at the tabular
// MINIBOONE width 43 -> 128 -> 128 -> 43 one sample's K2 residuals are about
// 1,400 floats, a basis block of K7 5.5 k: no thread slot fits beside the
// weights, and four dz-vectors of 64 floats in registers pass the 255
// register limit.  Here a layer's product over a tile is a small
// (T x in) . (in x out) product in shared memory; each thread owns a few
// rows (samples, or basis rows) of two output columns at a time, keeps
// their sums in registers, and reads each weight once for all its rows and
// the inputs as float4 broadcasts (tile_mm_rows).
//
// What lives where (floats; the numbers at 43 -> 128 -> 128 -> 43):
//   * the weights, all layers, in shared memory in their forward orientation
//     (in, pitch) with an odd pitch out | 1, and the biases (27,862: 111 KB).
//     A product reads W[k][o] with a warp's lanes on consecutive o, its
//     transpose (tile_mm_t) W[k][o] with the lanes on consecutive k: with an
//     odd pitch both touch 32 different banks, so no transposed copy is kept
//     (it would take the weights to 198 KB);
//   * a tile's vectors in shared memory, one (T, pitch) array per level and
//     role, the rows at pitches rounded up to 4 floats (44 for a dz-vector,
//     128 for a hidden level) so that each row starts 16-byte aligned for
//     the float4 reads; the hidden levels of one role form a hidden block of
//     hsum floats a row.
// The kernels' headers add up their own tile arrays.  A chain whose weights
// and smallest tile do not fit in the 227 KB a block may use gets no
// co-resident grid (the launch shape is refused).
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.

#pragma once

#include "chain_common.cuh"

namespace cnf {

constexpr int kWideMaxDz = 64;      // state width the wide forms take
constexpr int kWideMaxWidth = 128;  // hidden width they take
constexpr int kWideBlock = 256;     // threads per block
constexpr int kRows = 4;            // rows of a tile product a thread keeps in registers

// Where a wide chain's pieces live.  Weight offsets are in floats from the
// start of the weight region; hidden-level offsets in floats per row of a
// hidden block (level l of a T-row block starts at T * hofs[l]).
struct WideLayout {
  int n;                        // layers
  int dz, zp;                   // state width and its row pitch, dz rounded up to 4
  int width[kMaxLayers + 1];    // level widths, width[0] = dz + nc, width[n] = dz
  int hp[kMaxLayers + 1];       // level row pitches (hp[0] = hp[n] = zp: level 0 holds z)
  int hofs[kMaxLayers + 1];     // hidden level l's offset in a hidden block
  int hsum, hmax;               // floats per row of a hidden block; widest hidden level
  int wofs[kMaxLayers];         // layer i's weights, (in, pitch[i]) row-major (layer 0: z rows, then ys rows)
  int pitch[kMaxLayers];        // out | 1 (odd)
  int bofs[kMaxLayers];         // layer i's bias
  int pofs[kMaxLayers];         // layer i's [W_i | b_i] in the flat params and gradient
  int P;                        // parameter count
  int wfloats;                  // floats of the weight region
  int act[kMaxLayers];          // 1: layer i is tanh, 0: identity
};

// Fill `L` for the widths (n + 1 of them, the input width dz + nc first, dz
// last); false if the wide forms do not take the chain: an unconditional
// instance takes nc = 0 only, a COND instance (`cond`) nc >= 1 only.
inline bool make_wide_layout(int n, const int* widths, WideLayout* L, bool cond = false) {
  if (n < 2 || n > kMaxLayers) return false;
  const int dz = widths[n];
  if (dz < 1 || dz > kWideMaxDz || (cond ? widths[0] <= dz : widths[0] != dz)) return false;
  *L = WideLayout{};
  L->n = n;
  L->dz = dz;
  L->zp = tile_pitch(dz);
  for (int l = 0; l <= n; ++l) L->width[l] = widths[l];
  L->hp[0] = L->hp[n] = L->zp;
  int hs = 0, hm = 0;
  for (int l = 1; l < n; ++l) {
    if (widths[l] < 1 || widths[l] > kWideMaxWidth) return false;
    L->hp[l] = tile_pitch(widths[l]);
    L->hofs[l] = hs;
    hs += L->hp[l];
    hm = widths[l] > hm ? widths[l] : hm;
  }
  L->hsum = hs;
  L->hmax = hm;
  int f = 0, po = 0;
  for (int i = 0; i < n; ++i) {
    const int in = widths[i], out = widths[i + 1];
    L->pofs[i] = po;
    po += in * out + out;
    L->wofs[i] = f;
    L->pitch[i] = out | 1;
    f += in * L->pitch[i];
    L->bofs[i] = f;
    f += out;
  }
  L->P = po;
  L->wfloats = round_up(f, 4);
  for (int i = 0; i < kMaxLayers; ++i) L->act[i] = 1;
  return true;
}

inline void set_wide_acts(WideLayout* L, int acts) {
  for (int i = 0; i < kMaxLayers; ++i) L->act[i] = (acts >> i) & 1;
}

// The conditioning inputs nc of a layout (0 for an unconditional chain).
__host__ __device__ __forceinline__ int wide_nc(const WideLayout& L) { return L.width[0] - L.dz; }

// Layer 0's ys rows (nc, pitch[0]) in the shared weight region w.
__device__ __forceinline__ const float* wide_ys_rows(const WideLayout& L, const float* w) {
  return w + L.wofs[0] + L.dz * L.pitch[0];
}

// The ys cotangent of layer 0 for a tile: KYS (T, nc) = -(ca ys-rows^T) per
// row, from the pre-activation cotangent CA (T, hp[1]) of layer 0's output
// (the k_ays rate: a_ys integrates -ct_ys).  Ends with a block barrier.
__device__ inline void wide_ys_cotangent(const WideLayout& L, const float* w, const float* CA, int T, float* KYS) {
  const int nc = wide_nc(L), H = L.width[1], hp = L.hp[1], p0 = L.pitch[0];
  const float* wy = wide_ys_rows(L, w);
  for (int idx = threadIdx.x; idx < T * nc; idx += blockDim.x) {
    const int t = idx / nc, c = idx % nc;
    float a = 0.f;
    for (int o = 0; o < H; ++o) a = fmaf(CA[t * hp + o], wy[c * p0 + o], a);
    KYS[idx] = -a;
  }
  __syncthreads();
}

// Copy of the layout in (static) shared memory.
__device__ inline void share_layout(const WideLayout& from, WideLayout* to) {
  if (threadIdx.x == 0) *to = from;
  __syncthreads();
}

// Copy the flat params [W0 | b0 | W1 | b1 | ...] (each W_i row-major
// (in, out)) into the shared layout `s`, zero in the pitch's pad column.
__device__ inline void load_wide_weights(const float* params, const WideLayout& L, float* s) {
  for (int i = 0; i < L.n; ++i) {
    const int in = L.width[i], out = L.width[i + 1], pitch = L.pitch[i];
    const float* W = params + L.pofs[i];
    const float* b = W + in * out;
    float* w = s + L.wofs[i];
    for (int idx = threadIdx.x; idx < in * pitch; idx += blockDim.x) {
      const int k = idx / pitch, o = idx % pitch;
      w[idx] = o < out ? W[(size_t)k * out + o] : 0.f;
    }
    for (int o = threadIdx.x; o < out; o += blockDim.x) s[L.bofs[i] + o] = b[o];
  }
}

// Level l's (T, hp[l]) array in a T-row hidden block HB.
__device__ __forceinline__ float* level(const WideLayout& L, float* HB, int T, int l) { return HB + T * L.hofs[l]; }
__device__ __forceinline__ const float* level(const WideLayout& L, const float* HB, int T, int l) {
  return HB + T * L.hofs[l];
}

// The products below: each thread owns R rows (R = 8 where that still
// gives every thread of the block a unit, else kRows) of two output columns
// o and o + ceil(out / 2) at a time, keeps their 2 R sums in registers, and
// per 4 inputs reads 8 weights (lanes on consecutive columns) and R float4
// broadcasts of the inputs: 8 + R loads per 8 R FMA.  X rows are 16-byte
// aligned (pitch a multiple of 4); the sums run in input order.

// Rows a thread of a product with `cols` output columns over T rows takes.
__device__ __forceinline__ bool eight_rows(int T, int cols) {
  return T % 8 == 0 && (T / 8) * ((cols + 1) / 2) >= (int)blockDim.x;
}

template <int R, class Store>
__device__ __forceinline__ void tile_mm_rows(const float* X, int xp, int in, const float* W, int wp,
                                             const float* bias, int out, int T, const Store& store) {
  const int half = (out + 1) / 2, units = (T / R) * half;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int g = u / half, o0 = u % half, o1 = o0 + half;
    const bool two = o1 < out;
    const float* x = X + g * R * xp;
    const float* w0 = W + o0;
    const float* w1 = W + (two ? o1 : o0);
    float a0[R], a1[R];
    const float b0 = bias ? bias[o0] : 0.f, b1 = bias && two ? bias[o1] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a0[r] = b0;
      a1[r] = b1;
    }
    int k = 0;
    for (; k + 4 <= in; k += 4) {
      float wa[4], wb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wa[j] = w0[(k + j) * wp];
        wb[j] = w1[(k + j) * wp];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(x + r * xp + k);
        a0[r] = fmaf(v.w, wa[3], fmaf(v.z, wa[2], fmaf(v.y, wa[1], fmaf(v.x, wa[0], a0[r]))));
        a1[r] = fmaf(v.w, wb[3], fmaf(v.z, wb[2], fmaf(v.y, wb[1], fmaf(v.x, wb[0], a1[r]))));
      }
    }
    for (; k < in; ++k) {
      const float wa = w0[k * wp], wb = w1[k * wp];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a0[r] = fmaf(x[r * xp + k], wa, a0[r]);
        a1[r] = fmaf(x[r * xp + k], wb, a1[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      store(g * R + r, o0, a0[r]);
      if (two) store(g * R + r, o1, a1[r]);
    }
  }
}

template <int R, class Store>
__device__ __forceinline__ void tile_mm_rows_t(const float* X, int xp, int out, const float* W, int wp, int in,
                                               int T, const Store& store) {
  const int half = (in + 1) / 2, units = (T / R) * half;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int g = u / half, k0 = u % half, k1 = k0 + half;
    const bool two = k1 < in;
    const float* x = X + g * R * xp;
    const float* w0 = W + k0 * wp;
    const float* w1 = W + (two ? k1 : k0) * wp;
    float a0[R], a1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a0[r] = 0.f;
      a1[r] = 0.f;
    }
    int o = 0;
    for (; o + 4 <= out; o += 4) {
      float wa[4], wb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wa[j] = w0[o + j];
        wb[j] = w1[o + j];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(x + r * xp + o);
        a0[r] = fmaf(v.w, wa[3], fmaf(v.z, wa[2], fmaf(v.y, wa[1], fmaf(v.x, wa[0], a0[r]))));
        a1[r] = fmaf(v.w, wb[3], fmaf(v.z, wb[2], fmaf(v.y, wb[1], fmaf(v.x, wb[0], a1[r]))));
      }
    }
    for (; o < out; ++o) {
      const float wa = w0[o], wb = w1[o];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a0[r] = fmaf(x[r * xp + o], wa, a0[r]);
        a1[r] = fmaf(x[r * xp + o], wb, a1[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      store(g * R + r, k0, a0[r]);
      if (two) store(g * R + r, k1, a1[r]);
    }
  }
}

// For t < T (a multiple of kRows) and o < out: store(t, o, a) with
// a = bias[o] (0 when bias is null) + sum_k X[t * xp + k] W[k * wp + o], the
// sum in k order.  X (T, xp) and W (in, wp) in shared memory; `store` must
// not write X.  Ends with a block barrier.
template <class Store>
__device__ __forceinline__ void tile_mm(const float* X, int xp, int in, const float* W, int wp, const float* bias,
                                        int out, int T, const Store& store) {
  if (eight_rows(T, out))
    tile_mm_rows<8>(X, xp, in, W, wp, bias, out, T, store);
  else
    tile_mm_rows<kRows>(X, xp, in, W, wp, bias, out, T, store);
  __syncthreads();
}

// The transposed product: for t < T and k < in, store(t, k, a) with
// a = sum_o X[t * xp + o] W[k * wp + o] (X (T, xp) holds out columns), the
// sum in o order: tile_mm with the roles of the weights' index and stride
// swapped (a warp's lanes on consecutive k, an odd wp keeps them on 32
// banks).  Ends with a block barrier.
template <class Store>
__device__ __forceinline__ void tile_mm_t(const float* X, int xp, int out, const float* W, int wp, int in, int T,
                                          const Store& store) {
  if (eight_rows(T, in))
    tile_mm_rows_t<8>(X, xp, out, W, wp, in, T, store);
  else
    tile_mm_rows_t<kRows>(X, xp, out, W, wp, in, T, store);
  __syncthreads();
}

// The chain's forward pass on a tile (fused_solve.py::_chain_fwd): Z (T, zp)
// in, the hidden activations to the hidden block HB, the output y to
// Y (T, zp).
__device__ inline void wide_forward(const WideLayout& L, const float* w, const float* Z, int T, float* HB,
                                    float* Y) {
  const int n = L.n;
  for (int i = 0; i < n; ++i) {
    const float* src = i == 0 ? Z : level(L, HB, T, i);
    float* dst = i == n - 1 ? Y : level(L, HB, T, i + 1);
    const int dp = L.hp[i + 1], on = L.act[i];
    tile_mm(src, L.hp[i], L.width[i], w + L.wofs[i], L.pitch[i], w + L.bofs[i], L.width[i + 1], T,
            [&](int t, int o, float a) { dst[t * dp + o] = activate(a, on); });
  }
}

// wide_forward of a COND instance (fused_solve.py::_chain_fwd on _zin, the
// narrow chain_forward<DZ, true>): layer 0 reads [z | ys], its z rows by the
// tile product from Z and its ys rows from YS (T, nc) added to each output
// before the activation; the layers above as in wide_forward.
__device__ inline void wide_forward_cond(const WideLayout& L, const float* w, const float* Z, const float* YS, int T,
                                         float* HB, float* Y) {
  const int n = L.n, nc = wide_nc(L), p0 = L.pitch[0];
  const float* wy = wide_ys_rows(L, w);
  for (int i = 0; i < n; ++i) {
    float* dst = i == n - 1 ? Y : level(L, HB, T, i + 1);
    const int dp = L.hp[i + 1], on = L.act[i];
    if (i == 0) {
      tile_mm(Z, L.zp, L.dz, w + L.wofs[0], p0, w + L.bofs[0], L.width[1], T, [&](int t, int o, float a) {
        for (int c = 0; c < nc; ++c) a = fmaf(YS[t * nc + c], wy[c * p0 + o], a);
        dst[t * dp + o] = activate(a, on);
      });
    } else {
      tile_mm(level(L, HB, T, i), L.hp[i], L.width[i], w + L.wofs[i], L.pitch[i], w + L.bofs[i], L.width[i + 1], T,
              [&](int t, int o, float a) { dst[t * dp + o] = activate(a, on); });
    }
  }
}

// One probe pullback eps^T J per row after wide_forward
// (fused_solve.py::_probe_pullback): V (T, zp) is the gated probe
// e gate(y).  Up the layers, each hidden level's activation h is replaced,
// in place, by the gated cotangent u gate(h) entering the layer below; EJ
// (T, zp) gets the cotangent of z.
__device__ inline void wide_pullback(const WideLayout& L, const float* w, const float* V, int T, float* HB,
                                     float* EJ) {
  const int n = L.n;
  for (int i = n - 1; i >= 1; --i) {
    const float* src = i == n - 1 ? V : level(L, HB, T, i + 1);
    float* h = level(L, HB, T, i);
    const int hp = L.hp[i], on = L.act[i - 1];
    tile_mm_t(src, L.hp[i + 1], L.width[i + 1], w + L.wofs[i], L.pitch[i], L.width[i], T,
              [&](int t, int k, float a) { h[t * hp + k] = a * gate(h[t * hp + k], on); });
  }
  const int zp = L.zp;
  tile_mm_t(level(L, HB, T, 1), L.hp[1], L.width[1], w + L.wofs[0], L.pitch[0], L.dz, T,
            [&](int t, int k, float a) { EJ[t * zp + k] = a; });
}

// wide_pullback with the activations kept (the probe instances, K6, run one
// pass per probe): each hidden level's gated cotangent goes to the hidden
// block GB, its activation read from HB, as chain_pullback_to does for one
// sample.  The one-probe instance keeps the in-place form above, so its
// machine code stays as it was.
__device__ inline void wide_pullback_to(const WideLayout& L, const float* w, const float* V, int T, const float* HB,
                                        float* GB, float* EJ) {
  const int n = L.n;
  for (int i = n - 1; i >= 1; --i) {
    const float* src = i == n - 1 ? V : level(L, GB, T, i + 1);
    const float* h = level(L, HB, T, i);
    float* g = level(L, GB, T, i);
    const int hp = L.hp[i], on = L.act[i - 1];
    tile_mm_t(src, L.hp[i + 1], L.width[i + 1], w + L.wofs[i], L.pitch[i], L.width[i], T,
              [&](int t, int k, float a) { g[t * hp + k] = a * gate(h[t * hp + k], on); });
  }
  const int zp = L.zp;
  tile_mm_t(level(L, GB, T, 1), L.hp[1], L.width[1], w + L.wofs[0], L.pitch[0], L.dz, T,
            [&](int t, int k, float a) { EJ[t * zp + k] = a; });
}

// One probe pushforward J eps per row after wide_forward
// (fused_solve.py::_probe_pushforward, K6): E (T, zp) holds the probes.
// Down the layers, level l's tangent t_l = u_l gate(h_l), u_l = t_(l-1)
// W_(l-1) (t_0 = eps), goes to the hidden block TB (h read from HB), and
// u_l to UB unless UB is null; A (T, zp) gets the output layer's product
// t_(N-1) W_(N-1) before its gate.  COND (K6 x K8): t_0 = [eps | 0], so
// layer 0's product reads its z rows alone (_probe_pushforward :318-321).
template <bool COND = false>
__device__ inline void wide_pushforward(const WideLayout& L, const float* w, const float* E, int T, const float* HB,
                                        float* UB, float* TB, float* A) {
  const int n = L.n;
  for (int i = 0; i < n - 1; ++i) {
    const float* src = i == 0 ? E : level(L, TB, T, i);
    const float* h = level(L, HB, T, i + 1);
    float* u = UB ? level(L, UB, T, i + 1) : nullptr;
    float* t = level(L, TB, T, i + 1);
    const int hp = L.hp[i + 1], on = L.act[i];
    tile_mm(src, L.hp[i], COND && i == 0 ? L.dz : L.width[i], w + L.wofs[i], L.pitch[i], nullptr, L.width[i + 1], T,
            [&](int r, int o, float a) {
              if (u) u[r * hp + o] = a;
              t[r * hp + o] = a * gate(h[r * hp + o], on);
            });
  }
  const int zp = L.zp;
  tile_mm(level(L, TB, T, n - 1), L.hp[n - 1], L.width[n - 1], w + L.wofs[n - 1], L.pitch[n - 1], nullptr, L.dz, T,
          [&](int r, int k, float a) { A[r * zp + k] = a; });
}

// The co-resident launch shape of a wide kernel: the first of the `n_opts`
// options (largest first) whose shared memory smem[o] leaves a co-resident
// grid, as out = {block, grid, option, smem bytes}: grid at most the
// co-resident one and the tiles of B samples at rows[o] samples a tile.
template <class Kernel>
inline int wide_shape(Kernel kernel, const size_t* smem, const int* rows, const int* option, int n_opts, int B,
                      int* out) {
  for (int o = 0; o < n_opts; ++o) {
    int cap = 0;
    if (coop_max_grid(kernel, smem[o], kWideBlock, &cap) == cudaSuccess && cap >= 1) {
      const int tiles = (B + rows[o] - 1) / rows[o];
      out[0] = kWideBlock;
      out[1] = tiles < cap ? tiles : cap;
      out[2] = option[o];
      out[3] = (int)smem[o];
      return (int)cudaSuccess;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cnf
