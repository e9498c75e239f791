// The chain layer of the deep-chain solve kernels (the K1 chain form, the K7
// TEST and exact forwards, the K2 chain form): a Dense chain of
// n = 2 .. kMaxLayers layers, widths dz + nc -> H1 -> ... -> H(n-1) -> dz
// with dz <= 32 (padded to DZ), hidden widths <= kMaxWidth and nc
// conditioning inputs (K8: a conditional net's first layer reads [z | ys],
// ys constant over the solve; nc = 0 for an unconditional net; a chain whose
// weights and slots do not fit in shared memory gets no co-resident grid).
// Each layer is tanh or identity (ChainLayout::act, K9): an identity layer
// skips tanhf, its gate 1 - h^2 is 1 and its second-order terms are 0.  With
// n = 2 there is no middle layer; the fused solve runs unconditional 2-layer
// tanh nets through K3, K1, K2 and K4 and takes these kernels for n >= 3,
// for every conditional net and for every net with an identity layer.
//
// What lives where:
//   * the weights and biases in shared memory, laid out by ChainLayout (made
//     on the host from the widths, copied into the kernel's arguments):
//       layer 0      (H1, DZ)  rows o: w[o][k] = W0[k][o], zero for k >= dz
//                    (its z rows), and (H1, nc) rows o: wy[o][c] =
//                    W0[dz + c][o] (its ys rows);
//       middle i     (in, pitch) = W_i padded to a multiple of kChunk
//                    columns, and its transpose (out, tpitch);
//       last layer   (H, DZ)  rows k: w[k][o] = W[k][o], zero for o >= dz;
//     each bias padded with zeros to its layer's row width;
//   * a sample's dz-vectors in registers (float[DZ]);
//   * its hidden vectors, and its ys (nc floats), in the thread's slot of
//     shared memory: one contiguous slot per thread at an odd stride, so a
//     warp reading entry k of its 32 slots touches 32 different banks.  A
//     "hidden block" holds one vector per hidden level l = 1 .. n-1, level l
//     at hofs[l].  The pullback and the basis push read only the z rows of
//     layer 0: the Jacobian is in z.
// Chains past these widths run the wide forms (chain_wide.cuh).
// The products: dz-vector times a (., DZ) row as float4 broadcasts (dot4,
// axpy4 of solve_common.cuh), and mv_cols for hidden-to-hidden layers, which
// keeps kChunk outputs in registers and reads each input once per chunk.
// Precision: f32 FMA on the CUDA cores.

#pragma once

#include "solve_common.cuh"

namespace cnf {

constexpr int kMaxLayers = 4;   // layers of a chain the chain kernels take
constexpr int kMaxWidth = 64;   // hidden width they take
constexpr int kChunk = 8;       // outputs of mv_cols kept in registers

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Where a chain's pieces live.  Offsets of the shared weights are in floats
// from the start of the weight region, all multiples of 4 (float4 reads).
struct ChainLayout {
  int n;                        // layers
  int dz, nc;                   // state width and conditioning inputs
  int width[kMaxLayers + 1];    // level widths, width[0] = dz + nc, width[n] = dz
  int wofs[kMaxLayers];         // layer i's weights (forward orientation; layer 0: its z rows)
  int yofs;                     // layer 0's ys rows, (H1, nc)
  int pitch[kMaxLayers];        // their row width
  int tofs[kMaxLayers];         // middle layers: the transpose
  int tpitch[kMaxLayers];
  int bofs[kMaxLayers];         // the bias
  int pofs[kMaxLayers];         // layer i's [W_i | b_i] in the flat params and gradient
  int P;                        // parameter count
  int hofs[kMaxLayers + 1];     // hidden level l's offset in a hidden block
  int hsum, hmax;               // sum and max of the hidden widths
  int wfloats;                  // floats of the weight region
  int act[kMaxLayers];          // 1: layer i is tanh, 0: identity
};

// Layer activations: tanh where `on`, else identity, and the gate (the
// activation's derivative, from its output h).
__device__ __forceinline__ float activate(float a, int on) { return on ? tanhf(a) : a; }
__device__ __forceinline__ float gate(float h, int on) { return on ? 1.f - h * h : 1.f; }

// Set the layers' activations from a bit mask (bit i: layer i is tanh).
inline void set_chain_acts(ChainLayout* L, int acts) {
  for (int i = 0; i < kMaxLayers; ++i) L->act[i] = (acts >> i) & 1;
}

// Fill `L` for the widths (n + 1 of them: the input width dz + nc first, dz
// last); false if the chain kernels compiled for DZ do not take the chain.
template <int DZ>
inline bool make_chain_layout(int n, const int* widths, ChainLayout* L) {
  if (n < 2 || n > kMaxLayers) return false;
  const int dz = widths[n], nc = widths[0] - widths[n];
  if (dz < 1 || dz > DZ || nc < 0) return false;
  *L = ChainLayout{};
  L->n = n;
  L->dz = dz;
  L->nc = nc;
  for (int l = 0; l <= n; ++l) L->width[l] = widths[l];
  int hs = 0, hm = 0;
  for (int l = 1; l < n; ++l) {
    if (widths[l] < 1 || widths[l] > kMaxWidth) return false;
    L->hofs[l] = hs;
    hs += widths[l];
    hm = widths[l] > hm ? widths[l] : hm;
  }
  int f = 0, po = 0;
  for (int i = 0; i < n; ++i) {
    const int in = widths[i], out = widths[i + 1];
    L->pofs[i] = po;
    po += in * out + out;
    L->wofs[i] = f;
    if (i == 0) {
      L->pitch[i] = DZ;
      f += round_up(out * DZ, 4);
      L->bofs[i] = f;
      f += round_up(out, 4);
      L->yofs = f;
      f += round_up(out * nc, 4);
    } else if (i == n - 1) {
      L->pitch[i] = DZ;
      f += in * DZ;
      L->bofs[i] = f;
      f += DZ;
    } else {
      L->pitch[i] = round_up(out, kChunk);
      f += in * L->pitch[i];
      L->tofs[i] = f;
      L->tpitch[i] = round_up(in, kChunk);
      f += out * L->tpitch[i];
      L->bofs[i] = f;
      f += L->pitch[i];
    }
  }
  L->P = po;
  L->hsum = hs;
  L->hmax = hm;
  L->wfloats = f;
  set_chain_acts(L, (1 << kMaxLayers) - 1);
  return true;
}

// Copy the flat params [W0 | b0 | W1 | b1 | ...] (each W_i row-major
// (in, out), as the wrappers pass them) into the shared layout `s`.
template <int DZ>
__device__ void load_chain_weights(const float* params, const ChainLayout& L, float* s) {
  for (int i = 0; i < L.n; ++i) {
    const int in = L.width[i], out = L.width[i + 1];
    const float* W = params + L.pofs[i];
    const float* b = W + in * out;
    float* w = s + L.wofs[i];
    float* bs = s + L.bofs[i];
    if (i == 0) {
      for (int idx = threadIdx.x; idx < out * DZ; idx += blockDim.x) {
        const int o = idx / DZ, k = idx % DZ;
        w[idx] = k < L.dz ? W[(size_t)k * out + o] : 0.f;
      }
      for (int o = threadIdx.x; o < round_up(out, 4); o += blockDim.x) bs[o] = o < out ? b[o] : 0.f;
      float* wy = s + L.yofs;
      for (int idx = threadIdx.x; idx < out * L.nc; idx += blockDim.x) {
        const int o = idx / L.nc, c = idx % L.nc;
        wy[idx] = W[(size_t)(L.dz + c) * out + o];
      }
    } else if (i == L.n - 1) {
      for (int idx = threadIdx.x; idx < in * DZ; idx += blockDim.x) {
        const int k = idx / DZ, o = idx % DZ;
        w[idx] = o < out ? W[(size_t)k * out + o] : 0.f;
      }
      for (int o = threadIdx.x; o < DZ; o += blockDim.x) bs[o] = o < out ? b[o] : 0.f;
    } else {
      const int pitch = L.pitch[i], tpitch = L.tpitch[i];
      float* wt = s + L.tofs[i];
      for (int idx = threadIdx.x; idx < in * pitch; idx += blockDim.x) {
        const int k = idx / pitch, o = idx % pitch;
        w[idx] = o < out ? W[(size_t)k * out + o] : 0.f;
      }
      for (int idx = threadIdx.x; idx < out * tpitch; idx += blockDim.x) {
        const int o = idx / tpitch, k = idx % tpitch;
        wt[idx] = k < in ? W[(size_t)k * out + o] : 0.f;
      }
      for (int o = threadIdx.x; o < pitch; o += blockDim.x) bs[o] = o < out ? b[o] : 0.f;
    }
  }
}

// For o < out: store(o, bias[o] + sum_k src[k] W[k * pitch + o]) (no bias
// when `bias` is null).  src is a thread's vector in shared memory (it must
// not be written by `store`); W (in, pitch) is in shared memory with pitch a
// multiple of kChunk.  kChunk outputs at a time in registers, each input read
// once per chunk, the weights as float4 broadcasts.
template <class Store>
__device__ __forceinline__ void mv_cols(const float* src, int in, const float* W, int pitch, const float* bias,
                                        int out, const Store& store) {
  for (int c = 0; c < out; c += kChunk) {
    float a[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) a[j] = bias ? bias[c + j] : 0.f;
    const float* wc = W + c;
    for (int k = 0; k < in; ++k) {
      const float x = src[k];
      const float4 w0 = *reinterpret_cast<const float4*>(wc + k * pitch);
      const float4 w1 = *reinterpret_cast<const float4*>(wc + k * pitch + 4);
      a[0] = fmaf(x, w0.x, a[0]);
      a[1] = fmaf(x, w0.y, a[1]);
      a[2] = fmaf(x, w0.z, a[2]);
      a[3] = fmaf(x, w0.w, a[3]);
      a[4] = fmaf(x, w1.x, a[4]);
      a[5] = fmaf(x, w1.y, a[5]);
      a[6] = fmaf(x, w1.z, a[6]);
      a[7] = fmaf(x, w1.w, a[7]);
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (c + j < out) store(c + j, a[j]);
  }
}

// The chain's forward pass of one sample on [z | ys] (fused_solve.py::
// _chain_fwd on _zin): the hidden activations to the hidden block H, the
// output y in registers (zero beyond dz: the padded columns of the last
// layer are zero, and either activation keeps 0).  COND: a conditional chain, ys its nc conditioning values
// (the thread's slot); an unconditional instance compiles without them, so
// the conditioning costs it no registers.
template <int DZ, bool COND>
__device__ void chain_forward(const ChainLayout& L, const float* s, const float (&z)[DZ], const float* ys,
                              float* H, float (&y)[DZ]) {
  const int n = L.n;
  {
    float* h1 = H + L.hofs[1];
    const float* w = s + L.wofs[0];
    const float* b = s + L.bofs[0];
    if constexpr (COND) {
      const float* wy = s + L.yofs;
      const int nc = L.nc;
      for (int o = 0; o < L.width[1]; ++o) {
        float a = dot4<DZ>(z, w + o * DZ) + b[o];
        for (int c = 0; c < nc; ++c) a = fmaf(ys[c], wy[o * nc + c], a);
        h1[o] = activate(a, L.act[0]);
      }
    } else {
      for (int o = 0; o < L.width[1]; ++o) h1[o] = activate(dot4<DZ>(z, w + o * DZ) + b[o], L.act[0]);
    }
  }
  for (int i = 1; i < n - 1; ++i) {
    float* dst = H + L.hofs[i + 1];
    const int on = L.act[i];
    mv_cols(H + L.hofs[i], L.width[i], s + L.wofs[i], L.pitch[i], s + L.bofs[i], L.width[i + 1],
            [&](int o, float a) { dst[o] = activate(a, on); });
  }
  const float* hl = H + L.hofs[n - 1];
  const float* w = s + L.wofs[n - 1];
#pragma unroll
  for (int k = 0; k < DZ; ++k) y[k] = s[L.bofs[n - 1] + k];
  for (int k = 0; k < L.width[n - 1]; ++k) axpy4<DZ>(y, hl[k], w + k * DZ);
  const int on = L.act[n - 1];
#pragma unroll
  for (int k = 0; k < DZ; ++k) y[k] = activate(y[k], on);
}

// One probe pullback eps^T J of one sample after chain_forward
// (fused_solve.py::_probe_pullback): `v` is the gated probe e gate(y) at
// the output.  Up the layers, each hidden level's activation h is replaced,
// in place, by the gated cotangent u gate(h) entering the layer below;
// eJ (registers) is the cotangent of z (layer 0's z rows only).
template <int DZ>
__device__ void chain_pullback(const ChainLayout& L, const float* s, const float (&v)[DZ], float* H,
                               float (&eJ)[DZ]) {
  const int n = L.n;
  {
    float* h = H + L.hofs[n - 1];
    const float* w = s + L.wofs[n - 1];
    const int on = L.act[n - 2];
    for (int k = 0; k < L.width[n - 1]; ++k) h[k] = dot4<DZ>(v, w + k * DZ) * gate(h[k], on);
  }
  for (int i = n - 2; i >= 1; --i) {
    float* h = H + L.hofs[i];
    const int on = L.act[i - 1];
    mv_cols(H + L.hofs[i + 1], L.width[i + 1], s + L.tofs[i], L.tpitch[i], nullptr, L.width[i],
            [&](int k, float a) { h[k] = a * gate(h[k], on); });
  }
#pragma unroll
  for (int i = 0; i < DZ; ++i) eJ[i] = 0.f;
  const float* v1 = H + L.hofs[1];
  const float* w = s + L.wofs[0];
  for (int o = 0; o < L.width[1]; ++o) axpy4<DZ>(eJ, v1[o], w + o * DZ);
}

// chain_pullback with the activations kept (the probe instance, K6, runs
// one pullback per probe): each hidden level's gated cotangent goes to the
// hidden block G, its activation h read from the hidden block H.  (The
// one-probe instance keeps the in-place form above: the two-block form
// cost its conditional instance 17 % on the H100, PERF.md.)
template <int DZ>
__device__ void chain_pullback_to(const ChainLayout& L, const float* s, const float (&v)[DZ], const float* H,
                                  float* G, float (&eJ)[DZ]) {
  const int n = L.n;
  {
    const float* h = H + L.hofs[n - 1];
    float* g = G + L.hofs[n - 1];
    const float* w = s + L.wofs[n - 1];
    const int on = L.act[n - 2];
    for (int k = 0; k < L.width[n - 1]; ++k) g[k] = dot4<DZ>(v, w + k * DZ) * gate(h[k], on);
  }
  for (int i = n - 2; i >= 1; --i) {
    const float* h = H + L.hofs[i];
    float* g = G + L.hofs[i];
    const int on = L.act[i - 1];
    mv_cols(G + L.hofs[i + 1], L.width[i + 1], s + L.tofs[i], L.tpitch[i], nullptr, L.width[i],
            [&](int k, float a) { g[k] = a * gate(h[k], on); });
  }
#pragma unroll
  for (int i = 0; i < DZ; ++i) eJ[i] = 0.f;
  const float* v1 = G + L.hofs[1];
  const float* w = s + L.wofs[0];
  for (int o = 0; o < L.width[1]; ++o) axpy4<DZ>(eJ, v1[o], w + o * DZ);
}

// One probe pushforward J eps of one sample after chain_forward
// (fused_solve.py::_probe_pushforward, K6): down the layers, each hidden
// level's tangent t = (t_prev W) gate(h) goes to the hidden block T (h read
// from H; the probe has no ys rows, so layer 0 reads its z rows only);
// Je (registers) is the output layer's product t W before its gate.
template <int DZ>
__device__ void chain_pushforward(const ChainLayout& L, const float* s, const float (&e)[DZ], const float* H,
                                  float* T, float (&Je)[DZ]) {
  const int n = L.n;
  {
    const float* h = H + L.hofs[1];
    float* t = T + L.hofs[1];
    const float* w = s + L.wofs[0];
    const int on = L.act[0];
    for (int o = 0; o < L.width[1]; ++o) t[o] = dot4<DZ>(e, w + o * DZ) * gate(h[o], on);
  }
  for (int i = 1; i < n - 1; ++i) {
    const float* h = H + L.hofs[i + 1];
    float* t = T + L.hofs[i + 1];
    const int on = L.act[i];
    mv_cols(T + L.hofs[i], L.width[i], s + L.wofs[i], L.pitch[i], nullptr, L.width[i + 1],
            [&](int o, float a) { t[o] = a * gate(h[o], on); });
  }
#pragma unroll
  for (int k = 0; k < DZ; ++k) Je[k] = 0.f;
  const float* tl = T + L.hofs[n - 1];
  const float* w = s + L.wofs[n - 1];
  for (int k = 0; k < L.width[n - 1]; ++k) axpy4<DZ>(Je, tl[k], w + k * DZ);
}

// Copy of the layout in (static) shared memory, where the kernel indexes it
// by the layer loop's dynamic index.
__device__ inline void share_layout(const ChainLayout& from, ChainLayout* to) {
  if (threadIdx.x == 0) *to = from;
  __syncthreads();
}

// The padded width DZ a chain of these widths is compiled for, 0 if none.
inline int chain_dz(int n, const int* widths) { return n >= 2 && n <= kMaxLayers ? padded_dz(widths[n]) : 0; }

// Whether the chain of these widths is conditional (its input is wider than
// its state): the kernels' COND instance.
inline bool chain_cond(int n, const int* widths) { return widths[0] > widths[n]; }

// Call f.template operator()<DZ, COND>() for the kernel instance a chain of
// these widths runs; `none` when no instance takes it.
template <class F, class R>
R dispatch_chain(int n, const int* widths, const F& f, R none) {
  const bool cond = chain_dz(n, widths) != 0 && chain_cond(n, widths);
  switch (chain_dz(n, widths)) {
    case 4: return cond ? f.template operator()<4, true>() : f.template operator()<4, false>();
    case 8: return cond ? f.template operator()<8, true>() : f.template operator()<8, false>();
    case 16: return cond ? f.template operator()<16, true>() : f.template operator()<16, false>();
    case 32: return cond ? f.template operator()<32, true>() : f.template operator()<32, false>();
    default: return none;
  }
}

// Copy sample s's conditioning ys[s] ((B, nc) row-major) into `dst` (the
// thread's slot).
__device__ __forceinline__ void load_cond(const ChainLayout& L, const float* ys, int s, float* dst) {
  for (int c = 0; c < L.nc; ++c) dst[c] = ys[(size_t)s * L.nc + c];
}

// A tile's conditioning (the wide and streamed forms' COND instances):
// YS (T, nc) = the conditioning ys[s0 + t] ((B, nc) row-major) for t < nv,
// 0 beyond.  Ends with a block barrier.
__device__ inline void load_tile_cond(const float* ys, int nc, int s0, int nv, int T, float* YS) {
  for (int idx = threadIdx.x; idx < T * nc; idx += blockDim.x)
    YS[idx] = idx / nc < nv ? ys[(size_t)s0 * nc + idx] : 0.f;
  __syncthreads();
}

}  // namespace cnf
