// The conditioning of the COND instances of the narrow 2-layer kernels (K8
// in K3, the K4 forward and the K4 adjoint): a conditional net's W1 reads
// [z | ys] (the JAX package's _zin, continuousnf_tpu/ops/fused_solve.py:265),
// so each hidden pre-activation adds ys . W1y[j], W1y the nc ys rows of W1.
// The kernels keep W1y transposed in shared memory (wy, (H, nc)) beside W1's
// z rows and read the sample's ys row from global memory once a field
// evaluation, the first kCondRegs values into registers: the hidden loop
// then adds nc FMA a unit from registers and shared memory, with no global
// load on its dependent chain (nc past kCondRegs reads the rest from global
// memory, L1-resident).
#pragma once

namespace cnf {

constexpr int kCondRegs = 4;

// A sample's first kCondRegs ys values in registers (COND); nothing in an
// unconditional field, which declares one and never uses it.
template <bool COND>
struct CondRegs {};
template <>
struct CondRegs<true> {
  float v[kCondRegs];
};

// A COND field's conditioning; nothing in an unconditional field.
template <bool COND>
struct CondRows {};
template <>
struct CondRows<true> {
  const float* ys;  // (B, nc), global memory
  const float* wy;  // (H, nc), shared memory: wy[j][c] = w1[dz + c][j]
  int nc;

  // Sample smp's first kCondRegs ys values (0 past nc).
  __device__ __forceinline__ void load(int smp, CondRegs<true>& yv) const {
    const float* row = ys + (size_t)smp * nc;
#pragma unroll
    for (int c = 0; c < kCondRegs; ++c) yv.v[c] = c < nc ? row[c] : 0.f;
  }

  // a + ys . wy[j] for sample smp, its first kCondRegs ys values in yv.
  __device__ __forceinline__ float add(float a, int j, const CondRegs<true>& yv, int smp) const {
    const float* w = wy + j * nc;
#pragma unroll
    for (int c = 0; c < kCondRegs; ++c)
      if (c < nc) a = fmaf(yv.v[c], w[c], a);
    for (int c = kCondRegs; c < nc; ++c) a = fmaf(ys[(size_t)smp * nc + c], w[c], a);
    return a;
  }
};

}  // namespace cnf
