// The streamed chain layer of the streamed solve kernels (the streamed K1
// and K2 chain forms, streamed K7 TEST and exact, streamed K3 and K5 through
// two_layer_stream.cuh): a Dense chain of n = 2 .. kMaxLayers tanh or
// identity layers (StreamLayout::act's mask, K9), widths dz + nc -> H1 ->
// ... -> H(n-1) -> dz with dz <= kStreamMaxDz and hidden widths of any size,
// evaluated by a whole block for a tile of rows (samples, or basis rows) at
// once, as the wide layer of chain_wide.cuh does, with the weights left in
// global memory.  The state width reaches 128 where the wide forms stop at
// 64: every UCI width of the README net family MLP((n_in, 3 n_in, n_in)),
// BSDS300's 126 included.  nc is 0 but for the COND instances (K8: a
// conditional net's first layer reads [z | ys], ys constant over the
// solve), as in the wide layout: width[0] = dz + nc, layer 0's ys rows are
// rows dz .. dz + nc - 1 of W0 (in, out) in the flat params, and a tile's ys
// values sit in a (T, nc) array beside its vectors.  The layout gains no
// field, so the unconditional instances' arguments and machine code stay
// as they were.  Only the forward reads the ys rows, in the epilogue of its
// first product (stream_forward<true>): the solver's stage input Z keeps
// its (T, zp) tile, which a (T, dz + nc) input tile would have to copy at
// every evaluation, and the nc rows add nc FMA an output.  The pullbacks
// and the pushforward (stream_pushforward<true>) read layer 0's z rows
// alone (the Jacobian is in z).
//
// Why: the wide forms keep all the weights in a block's shared memory, which
// ends at hidden width 128 or about 56 k floats of weights.  FFJORD's tabular
// MINIBOONE model 43 -> 860 -> 860 -> 43 has 813,560 weights (3.25 MB): 14x
// a block's shared memory, but 7 % of the H100's 50 MB L2.  Here the weights
// stay in global memory, where every block reads the same 3.25 MB and the L2
// keeps them, and each product streams them through one chunk buffer of
// kChunkFloats floats of shared memory.
//
// The products (stream_mm, stream_mm_t): a (M x in) . (in x out) tile
// product, or its transpose, with M the tile's rows.  Its outputs go in
// chunks of OC columns, OC the largest power of two up to blockDim R / M,
// so that each thread owns R
// rows of one output column of the chunk and keeps their sums in registers
// over the whole reduction; the reduction runs in chunks of the weights
// (the rows of the chunk's columns, or for the transpose the chunk's rows of
// W, at an odd pitch), each loaded by the whole block with neighbouring
// threads on neighbouring addresses, the next chunk's loads in flight while
// the block computes on the current one, then read by a warp's lanes on
// consecutive output columns (no bank conflict).  The sums
// run in input order from the bias, as the wide layer's.  A weight loaded
// into shared memory serves the tile's M rows: M FMA per weight read from
// the L2.
//
// Where the tile's vectors live: a kernel's tile arrays (the solver's
// stage input and output, the hidden blocks, the residuals, K7's basis
// chunks) go in shared memory beside the chunk buffer when they fit, and
// otherwise in a block-owned slice of a global scratch (the wrapper
// allocates grid x region floats).  The code reads them through generic
// pointers either way; __syncthreads() makes a block's global writes
// visible to its own threads as it does its shared ones.
// Precision: f32 FMA on the CUDA cores, no TF32 and no tensor cores.

#pragma once

#include "chain_common.cuh"

namespace cnf {

constexpr int kStreamMaxDz = 128;     // state width the streamed forms take
constexpr int kStreamBlock = 256;     // threads per block
constexpr int kChunkFloats = 4352;    // the weight chunk buffer (17 KB): a chunk and its pad column
constexpr int kWeightChunk = 4096;    // weights a chunk (a power of two, a multiple of kStreamBlock)

// Where a streamed chain's pieces live.  The weights stay in the flat params
// [W0 | b0 | W1 | b1 | ...] (each W_i row-major (in, out)) in global memory;
// hidden-level offsets are in floats per row of a hidden block (level l of a
// T-row block starts at T * hofs[l]).
struct StreamLayout {
  int n;                        // layers
  int dz, zp;                   // state width and its row pitch, dz rounded up to 4
  int width[kMaxLayers + 1];    // level widths, width[0] = dz + nc, width[n] = dz
  int hp[kMaxLayers + 1];       // level row pitches (hp[0] = hp[n] = zp: a tile's z rows)
  int hofs[kMaxLayers + 1];     // hidden level l's offset in a hidden block
  int hsum, hmax;               // floats per row of a hidden block; widest hidden level
  int pofs[kMaxLayers];         // layer i's [W_i | b_i] in the flat params and gradient
  int P;                        // parameter count
  int act[kMaxLayers];          // 1: layer i is tanh, 0: identity
};

// Fill `L` for the widths (n + 1 of them, the input width dz + nc first, dz
// last); false if the streamed forms do not take the chain: an
// unconditional instance takes nc = 0 only, a COND instance (`cond`) nc >= 1
// only; chains of 2^31 or more parameters, whose offsets an int does not
// hold, neither.
inline bool make_stream_layout(int n, const int* widths, StreamLayout* L, bool cond = false) {
  if (n < 2 || n > kMaxLayers) return false;
  const int dz = widths[n];
  if (dz < 1 || dz > kStreamMaxDz || (cond ? widths[0] <= dz : widths[0] != dz)) return false;
  *L = StreamLayout{};
  L->n = n;
  L->dz = dz;
  L->zp = tile_pitch(dz);
  for (int l = 0; l <= n; ++l) L->width[l] = widths[l];
  L->hp[0] = L->hp[n] = L->zp;
  long long hs = 0;
  int hm = 0;
  for (int l = 1; l < n; ++l) {
    if (widths[l] < 1) return false;
    L->hp[l] = tile_pitch(widths[l]);
    L->hofs[l] = (int)hs;
    hs += L->hp[l];
    hm = widths[l] > hm ? widths[l] : hm;
  }
  long long po = 0;
  for (int i = 0; i < n; ++i) {
    L->pofs[i] = (int)po;
    po += (long long)widths[i] * widths[i + 1] + widths[i + 1];
    if (po >= (1LL << 31) || hs >= (1LL << 24)) return false;
  }
  L->hsum = (int)hs;
  L->hmax = hm;
  L->P = (int)po;
  for (int i = 0; i < kMaxLayers; ++i) L->act[i] = 1;
  return true;
}

inline void set_stream_acts(StreamLayout* L, int acts) {
  for (int i = 0; i < kMaxLayers; ++i) L->act[i] = (acts >> i) & 1;
}

// The conditioning inputs nc of a layout (0 for an unconditional chain).
__host__ __device__ __forceinline__ int stream_nc(const StreamLayout& L) { return L.width[0] - L.dz; }

// Copy of the layout in (static) shared memory.
__device__ inline void share_layout(const StreamLayout& from, StreamLayout* to) {
  if (threadIdx.x == 0) *to = from;
  __syncthreads();
}

// Layer i's weights W_i (in, out) and bias in the flat params.
__device__ __forceinline__ const float* layer_w(const StreamLayout& L, const float* params, int i) {
  return params + L.pofs[i];
}
__device__ __forceinline__ const float* layer_b(const StreamLayout& L, const float* params, int i) {
  return params + L.pofs[i] + L.width[i] * L.width[i + 1];
}

// Level l's (T, hp[l]) array in a T-row hidden block HB.
__device__ __forceinline__ float* level(const StreamLayout& L, float* HB, int T, int l) {
  return HB + (size_t)T * L.hofs[l];
}
__device__ __forceinline__ const float* level(const StreamLayout& L, const float* HB, int T, int l) {
  return HB + (size_t)T * L.hofs[l];
}

// The product with TRANS false: store(t, j, a) for t < M and j < nout with
// a = bias[j] (0 when bias is null) + sum_i X[t * xp + i] W[i * ldw + j]
// (W (nred, ldw) in global memory); with TRANS true: a = sum_i X[t * xp + i]
// W[j * ldw + i] (the rows of W are the outputs), no bias.  X (M, xp) in
// shared or global memory, 16-byte aligned rows (xp a multiple of 4); the
// sums run in i order.  Each thread owns R rows of one output column of a
// chunk of OC columns (module comment); `store` must not write X.  wc: the
// kChunkFloats-float chunk buffer in shared memory.  Needs blockDim.x ==
// kStreamBlock.  Ends with a block barrier.
//
// The chunks' weights (kWeightChunk floats: RC reduction entries of OC
// columns, OC and RC powers of two) go through registers: each thread loads
// kLoads of the next chunk from global memory while the block computes on
// the current one in shared memory, so the L2's latency overlaps the FMA,
// and stores them after the next barrier.  A thread's loads of a forward
// chunk are the column it computes on (rows apart by kStreamBlock / OC); of
// a transposed chunk, consecutive entries of W's rows.  W is read through
// the read-only path (__ldg) unless COHERENT: a W that the kernel wrote
// itself before a grid barrier (streamed K3's and K5's M) is read through
// the L2 (__ldcg).
template <bool TRANS, int R, class Store, bool COHERENT = false>
__device__ __forceinline__ void stream_mm_rows(const float* X, int xp, int nred, const float* W, int ldw,
                                               const float* bias, int nout, int M, float* wc, const Store& store) {
  constexpr int kLoads = kWeightChunk / kStreamBlock;
  const int G = M / R;
  int OC = 1;
  while (2 * OC * G <= kStreamBlock) OC *= 2;
  const int RC = kWeightChunk / OC, rc_shift = __ffs(RC) - 1;
  const int wp = TRANS ? RC + 1 : OC;  // an odd pitch for the transpose's rows
  const int g = threadIdx.x / OC, j = threadIdx.x % OC;
  const int pass_rows = kStreamBlock / OC;  // forward chunk rows one pass of the block loads
  const float* x = X + (size_t)(g < G ? g : 0) * R * xp;
  const int nj = (nout + OC - 1) / OC, ni = (nred + RC - 1) / RC, nc = nj * ni;
  float v[kLoads];
  // Chunk c (output chunk c / ni, reduction chunk c % ni): (jj, ii) of the
  // thread's q-th entry, and whether it lies inside the weights.
  auto entry = [&](int c, int q, int* jj, int* ii) {
    const int j0 = (c / ni) * OC, i0 = (c % ni) * RC;
    if (TRANS) {
      const int idx = threadIdx.x + q * kStreamBlock;
      *jj = idx >> rc_shift;
      *ii = idx & (RC - 1);
    } else {
      *jj = j;
      *ii = q * pass_rows + g;
    }
    return j0 + *jj < nout && i0 + *ii < nred;
  };
  auto fetch = [&](int c) {
    const int j0 = (c / ni) * OC, i0 = (c % ni) * RC;
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      int jj, ii;
      const bool inside = entry(c, q, &jj, &ii);
      if constexpr (COHERENT)
        v[q] = inside ? __ldcg(W + (TRANS ? (size_t)(j0 + jj) * ldw + i0 + ii : (size_t)(i0 + ii) * ldw + j0 + jj)) : 0.f;
      else
        v[q] = inside ? __ldg(W + (TRANS ? (size_t)(j0 + jj) * ldw + i0 + ii : (size_t)(i0 + ii) * ldw + j0 + jj)) : 0.f;
    }
  };
  auto put = [&](int c) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      int jj, ii;
      entry(c, q, &jj, &ii);
      wc[TRANS ? jj * wp + ii : ii * wp + jj] = v[q];
    }
  };
  float a[R];
  fetch(0);
  for (int c = 0; c < nc; ++c) {
    const int j0 = (c / ni) * OC, i0 = (c % ni) * RC;
    const int jn = min(OC, nout - j0), in = min(RC, nred - i0);
    const bool active = g < G && j < jn;
    if (c % ni == 0) {
      const float b = bias && active ? __ldg(bias + j0 + j) : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = b;
    }
    __syncthreads();  // the previous chunk's readers are done
    put(c);
    __syncthreads();
    if (c + 1 < nc) fetch(c + 1);
    if (active) {
      const float* w = TRANS ? wc + j * wp : wc + j;
      const int ws = TRANS ? 1 : wp;
      const float* xi = x + i0;
      int ii = 0;
      for (; ii + 4 <= in; ii += 4) {
        float w4[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) w4[q] = w[(ii + q) * ws];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xi + r * xp + ii);
          a[r] = fmaf(xv.w, w4[3], fmaf(xv.z, w4[2], fmaf(xv.y, w4[1], fmaf(xv.x, w4[0], a[r]))));
        }
      }
      for (; ii < in; ++ii) {
        const float w1 = w[ii * ws];
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = fmaf(xi[r * xp + ii], w1, a[r]);
      }
      if (c % ni == ni - 1) {
#pragma unroll
        for (int r = 0; r < R; ++r) store(g * R + r, j0 + j, a[r]);
      }
    }
  }
  __syncthreads();
}

// Rows a thread of a product over M rows keeps: 8 from 16 rows up (in
// groups of 8), else 4.  M is a multiple of 4 and at most 4 blockDim.
__device__ __forceinline__ bool stream_eight_rows(int M) { return M % 8 == 0 && M >= 16; }

// For t < M and o < out: store(t, o, bias[o] + sum_k X[t * xp + k] W[k][o]),
// W (in, out) row-major in global memory (a layer's forward product).
template <bool COHERENT = false, class Store>
__device__ __forceinline__ void stream_mm(const float* X, int xp, int in, const float* W, const float* bias, int out,
                                          int M, float* wc, const Store& store) {
  if (stream_eight_rows(M))
    stream_mm_rows<false, 8, Store, COHERENT>(X, xp, in, W, out, bias, out, M, wc, store);
  else
    stream_mm_rows<false, 4, Store, COHERENT>(X, xp, in, W, out, bias, out, M, wc, store);
}

// The transposed product: for t < M and k < in, store(t, k, sum_o
// X[t * xp + o] W[k][o]) (X holds out columns), the sum in o order.
template <bool COHERENT = false, class Store>
__device__ __forceinline__ void stream_mm_t(const float* X, int xp, int out, const float* W, int in, int M, float* wc,
                                            const Store& store) {
  if (stream_eight_rows(M))
    stream_mm_rows<true, 8, Store, COHERENT>(X, xp, out, W, out, nullptr, in, M, wc, store);
  else
    stream_mm_rows<true, 4, Store, COHERENT>(X, xp, out, W, out, nullptr, in, M, wc, store);
}

// The chain's forward pass on a tile (fused_solve.py::_chain_fwd): Z (T, zp)
// in, the hidden activations to the hidden block HB, the output y to
// Y (T, zp).  COND (the COND instances, fused_solve.py::_zin): layer 0 reads
// [z | ys], its z rows by the product from Z and its ys rows (from global
// memory, L2-resident with the weights) times YS (T, nc) added to each
// output before the activation, after the z rows' sum.
template <bool COND = false>
__device__ inline void stream_forward(const StreamLayout& L, const float* params, const float* Z, int T, float* HB,
                                      float* Y, float* wc, [[maybe_unused]] const float* YS = nullptr) {
  const int n = L.n;
  for (int i = 0; i < n; ++i) {
    const float* src = i == 0 ? Z : level(L, HB, T, i);
    float* dst = i == n - 1 ? Y : level(L, HB, T, i + 1);
    const int dp = L.hp[i + 1], on = L.act[i];
    if constexpr (COND) {
      if (i == 0) {
        const int nc = stream_nc(L), H = L.width[1];
        const float* wy = layer_w(L, params, 0) + (size_t)L.dz * H;
        stream_mm(Z, L.zp, L.dz, layer_w(L, params, 0), layer_b(L, params, 0), H, T, wc, [&](int t, int o, float a) {
          for (int c = 0; c < nc; ++c) a = fmaf(YS[t * nc + c], __ldg(wy + (size_t)c * H + o), a);
          dst[t * dp + o] = activate(a, on);
        });
        continue;
      }
    }
    stream_mm(src, L.hp[i], L.width[i], layer_w(L, params, i), layer_b(L, params, i), L.width[i + 1], T, wc,
              [&](int t, int o, float a) { dst[t * dp + o] = activate(a, on); });
  }
}

// One probe pullback eps^T J per row after stream_forward
// (fused_solve.py::_probe_pullback): V (T, zp) is the gated probe
// e gate(y).  Up the layers, each hidden level's activation h is replaced,
// in place, by the gated cotangent u gate(h) entering the layer below; EJ
// (T, zp) gets the cotangent of z.
__device__ inline void stream_pullback(const StreamLayout& L, const float* params, const float* V, int T, float* HB,
                                       float* EJ, float* wc) {
  const int n = L.n;
  for (int i = n - 1; i >= 1; --i) {
    const float* src = i == n - 1 ? V : level(L, HB, T, i + 1);
    float* h = level(L, HB, T, i);
    const int hp = L.hp[i], on = L.act[i - 1];
    stream_mm_t(src, L.hp[i + 1], L.width[i + 1], layer_w(L, params, i), L.width[i], T, wc,
                [&](int t, int k, float a) { h[t * hp + k] = a * gate(h[t * hp + k], on); });
  }
  const int zp = L.zp;
  stream_mm_t(level(L, HB, T, 1), L.hp[1], L.width[1], layer_w(L, params, 0), L.dz, T, wc,
              [&](int t, int k, float a) { EJ[t * zp + k] = a; });
}

// stream_pullback with the activations kept (the probe instances, K6, run
// one pass per probe): each hidden level's gated cotangent goes to the
// hidden block GB, its activation read from HB, as wide_pullback_to does.
// The one-probe instances keep the in-place form above.
__device__ inline void stream_pullback_to(const StreamLayout& L, const float* params, const float* V, int T,
                                          const float* HB, float* GB, float* EJ, float* wc) {
  const int n = L.n;
  for (int i = n - 1; i >= 1; --i) {
    const float* src = i == n - 1 ? V : level(L, GB, T, i + 1);
    const float* h = level(L, HB, T, i);
    float* g = level(L, GB, T, i);
    const int hp = L.hp[i], on = L.act[i - 1];
    stream_mm_t(src, L.hp[i + 1], L.width[i + 1], layer_w(L, params, i), L.width[i], T, wc,
                [&](int t, int k, float a) { g[t * hp + k] = a * gate(h[t * hp + k], on); });
  }
  const int zp = L.zp;
  stream_mm_t(level(L, GB, T, 1), L.hp[1], L.width[1], layer_w(L, params, 0), L.dz, T, wc,
              [&](int t, int k, float a) { EJ[t * zp + k] = a; });
}

// One probe pushforward J eps per row after stream_forward
// (fused_solve.py::_probe_pushforward, K6): E (T, zp) holds the probes.
// Down the layers, level l's tangent t_l = u_l gate(h_l), u_l = t_(l-1)
// W_(l-1) with no bias (t_0 = eps), goes to the hidden block TB (h read
// from HB), and u_l to UB unless UB is null; A (T, zp) gets the output
// layer's product t_(N-1) W_(N-1) before its gate.  COND (the probe COND
// instances, K6 x K8): the tangent of [z | ys] is [eps | 0]
// (_probe_pushforward :318-321), so layer 0's product reads its dz z rows.
template <bool COND = false>
__device__ inline void stream_pushforward(const StreamLayout& L, const float* params, const float* E, int T,
                                          const float* HB, float* UB, float* TB, float* A, float* wc) {
  const int n = L.n;
  for (int i = 0; i < n - 1; ++i) {
    const float* src = i == 0 ? E : level(L, TB, T, i);
    const float* h = level(L, HB, T, i + 1);
    float* u = UB ? level(L, UB, T, i + 1) : nullptr;
    float* t = level(L, TB, T, i + 1);
    const int hp = L.hp[i + 1], on = L.act[i];
    stream_mm(src, L.hp[i], COND && i == 0 ? L.dz : L.width[i], layer_w(L, params, i), nullptr, L.width[i + 1], T,
              wc, [&](int r, int o, float a) {
                if (u) u[r * hp + o] = a;
                t[r * hp + o] = a * gate(h[r * hp + o], on);
              });
  }
  const int zp = L.zp;
  stream_mm(level(L, TB, T, n - 1), L.hp[n - 1], L.width[n - 1], layer_w(L, params, n - 1), nullptr, L.dz, T, wc,
            [&](int r, int k, float a) { A[r * zp + k] = a; });
}

// The launch shape of a streamed kernel: the first of the `n_opts` options
// (largest first) whose tile arrays (region[o] floats) fit in shared memory
// beside the chunk buffer and the reduction slots with a co-resident grid;
// else the first option with its tile arrays in a global scratch.  out =
// {block, grid, option, smem bytes, the global scratch's floats a block (0:
// none)}: grid at most the co-resident one and the tiles of B samples at
// rows[o] samples a tile.
template <class Kernel>
inline int stream_shape(Kernel kernel, const size_t* region, const int* rows, const int* option, int n_opts, int B,
                        int* out) {
  const size_t base = sizeof(float) * (size_t)(kChunkFloats + kRedFloats);
  for (int pass = 0; pass < 2; ++pass) {
    for (int o = 0; o < (pass == 0 ? n_opts : 1); ++o) {
      const size_t smem = base + (pass == 0 ? sizeof(float) * region[o] : 0);
      int cap = 0;
      if (coop_max_grid(kernel, smem, kStreamBlock, &cap) == cudaSuccess && cap >= 1) {
        const int tiles = (B + rows[o] - 1) / rows[o];
        out[0] = kStreamBlock;
        out[1] = tiles < cap ? tiles : cap;
        out[2] = option[o];
        out[3] = (int)smem;
        out[4] = pass == 0 ? 0 : (int)region[o];
        return (int)cudaSuccess;
      }
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cnf
