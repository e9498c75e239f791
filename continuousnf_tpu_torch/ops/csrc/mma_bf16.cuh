// Warp-level bf16 tensor-core building blocks of the bf16 kernels (bf16 K3,
// K1 and K2: k3_bf16_solve.cu, k1_bf16_solve.cu, k2_bf16_adjoint.cu), and
// the 2-layer net's bf16 layout in shared memory that the three share.
//
// The JAX package's single-pass bf16 stage dots (continuousnf_tpu/ops/
// fused_solve.py::_mm with "bf16", :193-225) round both operands to bf16
// (round to nearest even), multiply them exactly and sum in f32.  On Hopper
// that is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: a warp
// multiplies a 16 x 16 bf16 tile A by a 16 x 8 bf16 tile B into a 16 x 8 f32
// accumulator.  (The products are exact in f32; the tensor core's sums within
// a k-block are not IEEE round-to-nearest and run in another order than the
// CPU's, so results part from the plain twin at f32 roundoff.)
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16" with bf16
// operands), lane l, g = l >> 2, q = l & 3; (row, col) of the tile:
//   A (16 x 16): a[0] = (g, 2q | 2q+1), a[1] = (g+8, 2q | 2q+1),
//                a[2] = (g, 2q+8 | 2q+9), a[3] = (g+8, 2q+8 | 2q+9),
//                two bf16 a register, the lower column in the low half;
//   B (16 x 8):  b[0] = (k 2q | 2q+1, n g), b[1] = (k 2q+8 | 2q+9, n g);
//   C (16 x 8, f32): c[0], c[1] = (g, 2q), (g, 2q+1); c[2], c[3] = (g+8, 2q),
//                (g+8, 2q+1).
// So two C tiles side by side (columns 0-7 and 8-15), after the bias, the
// tanh and the RNE packing, are the A fragment of one k16 step of the next
// product (`c_to_a`), and a row's sum over a C tile's columns is a sum over
// the quad of lanes of one g (`quad_sum`).
//
// Fragments come from shared memory with ldmatrix: a B operand from rows
// W[n][k] (each row a column of B, 16-byte aligned), and, for the weight
// gradients whose contraction runs over the samples, both operands from the
// samples' rows X[s][.] with ldmatrix.trans.
//
// No wgmma and no TMA: the products are small (16 x 48 x 16 at the flagship),
// one warp's 32 samples at a time.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "solve_common.cuh"

namespace cnf {
namespace bf16 {

// Round (lo, hi) to bf16, nearest even, into one register: lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += A B on the tensor cores (bf16 inputs, f32 accumulation).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l & 7 of matrix
// l >> 3.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// Two matrices; lanes 0-15 give the addresses (the others' are not read).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// The B fragments of two n8 tiles (columns n0.. and n0 + 8..) at k0 from bf16
// rows W[n][k] of pitch P: b[0..1] the first tile, b[2..3] the second.
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const __nv_bfloat16* W, int P, int n0, int k0) {
  const int l = lane_id(), m = l >> 3;
  ldmatrix_x4(b, W + (size_t)(n0 + (m >> 1) * 8 + (l & 7)) * P + k0 + (m & 1) * 8);
}

// The A fragment (rows m0.., k = samples k0..) of X^T from the samples' rows
// X[s][m] of pitch P (ldmatrix.trans).
__device__ __forceinline__ void load_at(uint32_t (&a)[4], const __nv_bfloat16* X, int P, int m0, int k0) {
  const int l = lane_id(), m = l >> 3;
  ldmatrix_x4_trans(a, X + (size_t)(k0 + (m >> 1) * 8 + (l & 7)) * P + m0 + (m & 1) * 8);
}

// The B fragment (k = samples k0.., columns n0..) from the samples' rows
// X[s][n] of pitch P (ldmatrix.trans).
__device__ __forceinline__ void load_bt(uint32_t (&b)[2], const __nv_bfloat16* X, int P, int n0, int k0) {
  const int l = lane_id() & 15;
  ldmatrix_x2_trans(b, X + (size_t)(k0 + l) * P + n0);
}

// The A fragment of the 16 x 16 block (rows r0.., columns c0..) of a
// row-major f32 array X of pitch ld, columns >= ncols read as 0, rounded.
__device__ __forceinline__ void load_a_f32(uint32_t (&a)[4], const float* X, int ld, int r0, int c0, int ncols) {
  const int l = lane_id(), g = l >> 2, c = c0 + 2 * (l & 3);
  auto at = [&](int r, int col) { return col < ncols ? X[(size_t)(r0 + r) * ld + col] : 0.f; };
  a[0] = pack(at(g, c), at(g, c + 1));
  a[1] = pack(at(g + 8, c), at(g + 8, c + 1));
  a[2] = pack(at(g, c + 8), at(g, c + 9));
  a[3] = pack(at(g + 8, c + 8), at(g + 8, c + 9));
}

// Two C tiles (columns 0-7 and 8-15 of a k16 step), rounded, as an A fragment.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Store an A fragment's bf16 pairs into rows X[r][c] of pitch P (rows r0..,
// columns c0..): the rounded operand, as the samples' rows keep it.
__device__ __forceinline__ void store_a(const uint32_t (&a)[4], __nv_bfloat16* X, int P, int r0, int c0) {
  const int l = lane_id(), g = l >> 2, c = c0 + 2 * (l & 3);
  *reinterpret_cast<uint32_t*>(X + (size_t)(r0 + g) * P + c) = a[0];
  *reinterpret_cast<uint32_t*>(X + (size_t)(r0 + g + 8) * P + c) = a[1];
  *reinterpret_cast<uint32_t*>(X + (size_t)(r0 + g) * P + c + 8) = a[2];
  *reinterpret_cast<uint32_t*>(X + (size_t)(r0 + g + 8) * P + c + 8) = a[3];
}

// Sum over the quad of lanes that share g (a row's columns of a C tile).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Sum over the eight g of a column (the lanes that share q).
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// The column of C element e (0..3) of n8 tile nt, and its row (g or g + 8).
__device__ __forceinline__ int c_col(int nt, int e) { return nt * 8 + 2 * (lane_id() & 3) + (e & 1); }
__device__ __forceinline__ int c_row(int e) { return (lane_id() >> 2) + (e >> 1) * 8; }

// ---- the 2-layer net in bf16 (unconditional, tanh on both layers) ----
//
// The state width dz padded to DZ (16 or 32, a multiple of the k16 step) and
// the hidden width H to HP (a multiple of 16), with zero weights and biases:
// a padded hidden unit has a = 0, h = tanh(0) = 0, and zero rows in W2 and in
// M, so it adds nothing; a padded output has y = 0 and adds nothing to the
// trace or the norms.  Rows are PZ = DZ + 8 or PH = HP + 8 bf16 long: 16-byte
// aligned for ldmatrix, and their 8 rows of one ldmatrix hit 8 different
// bank quads.
struct Net {
  int dz, H, HP, PZ, PH;
  const __nv_bfloat16* w1t;  // (HP, PZ): W1^T, the B of z W1 and of ct W1 (n = hidden, k = state)
  const __nv_bfloat16* w2t;  // (DZ, PH): W2^T, the B of h W2 (n = state, k = hidden)
  const __nv_bfloat16* w2r;  // (HP, PZ): W2, the B of v W2^T (n = hidden, k = state)
  const __nv_bfloat16* w1r;  // (DZ, PH): W1, the B of v W1^T (n = state, k = hidden)
  const __nv_bfloat16* mr;   // (DZ, PH): M = W1 * W2^T rounded after the f32 product (K3), or null
  const float* b1;           // (HP)
  const float* b2;           // (DZ)
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// The padded state width a bf16 kernel is compiled for (16 or 32), 0 if none.
inline int padded_dz(int dz) { return dz < 1 ? 0 : dz <= 16 ? 16 : dz <= 32 ? 32 : 0; }

// The bf16 elements of one (rows, pitch) matrix, rounded up to 8 (16 bytes).
__host__ __device__ inline size_t mat_elems(int rows, int pitch) { return ((size_t)rows * pitch + 7) / 8 * 8; }

// Bytes of the net in shared memory: four weight matrices (five with M) and
// the two f32 biases, a multiple of 16.
template <int DZ>
__host__ __device__ inline size_t net_bytes(int H, bool with_m) {
  const int HP = round16(H), PZ = DZ + 8, PH = HP + 8;
  const size_t e = 2 * mat_elems(HP, PZ) + (with_m ? 3 : 2) * mat_elems(DZ, PH);
  return 2 * e + 4 * (size_t)((HP + DZ + 3) / 4 * 4);
}

// Round the f32 weights (w1 (dz, H), w2 (H, dz), global) into the block's
// shared memory at `base` (net_bytes<DZ>(H, with_m) bytes), M from the f32
// product W1[i][j] W2[j][i].  Ends with a block barrier.
template <int DZ>
__device__ Net load_net(const float* w1, const float* b1, const float* w2, const float* b2, int dz, int H,
                        bool with_m, unsigned char* base) {
  Net n;
  n.dz = dz;
  n.H = H;
  n.HP = round16(H);
  n.PZ = DZ + 8;
  n.PH = n.HP + 8;
  __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* w1t = p;
  __nv_bfloat16* w2r = w1t + mat_elems(n.HP, n.PZ);
  __nv_bfloat16* w2t = w2r + mat_elems(n.HP, n.PZ);
  __nv_bfloat16* w1r = w2t + mat_elems(DZ, n.PH);
  __nv_bfloat16* mr = w1r + mat_elems(DZ, n.PH);
  float* fb = reinterpret_cast<float*>(mr + (with_m ? mat_elems(DZ, n.PH) : 0));
  for (int idx = threadIdx.x; idx < n.HP * n.PZ; idx += blockDim.x) {
    const int j = idx / n.PZ, i = idx % n.PZ;
    const bool in = i < dz && j < H;
    w1t[idx] = __float2bfloat16_rn(in ? w1[(size_t)i * H + j] : 0.f);
    w2r[idx] = __float2bfloat16_rn(in ? w2[(size_t)j * dz + i] : 0.f);
  }
  for (int idx = threadIdx.x; idx < DZ * n.PH; idx += blockDim.x) {
    const int i = idx / n.PH, j = idx % n.PH;
    const bool in = i < dz && j < H;
    const float a = in ? w1[(size_t)i * H + j] : 0.f, b = in ? w2[(size_t)j * dz + i] : 0.f;
    w2t[idx] = __float2bfloat16_rn(b);
    w1r[idx] = __float2bfloat16_rn(a);
    if (with_m) mr[idx] = __float2bfloat16_rn(a * b);
  }
  for (int j = threadIdx.x; j < n.HP; j += blockDim.x) fb[j] = j < H ? b1[j] : 0.f;
  for (int k = threadIdx.x; k < DZ; k += blockDim.x) fb[n.HP + k] = k < dz ? b2[k] : 0.f;
  __syncthreads();
  n.w1t = w1t;
  n.w2r = w2r;
  n.w2t = w2t;
  n.w1r = w1r;
  n.mr = with_m ? mr : nullptr;
  n.b1 = fb;
  n.b2 = fb + n.HP;
  return n;
}

// One m16 tile's hidden chunk c (16 hidden units): the A fragments x of its
// DZ / 16 k-steps times the B rows W (n = hidden, pitch P) into two C tiles.
template <int DZ>
__device__ __forceinline__ void chunk_mm(float (&acc)[2][4], const uint32_t (&x)[DZ / 16][4],
                                         const __nv_bfloat16* W, int P, int c) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DZ / 16; ++ks) {
    uint32_t b[4];
    load_b2(b, W, P, c * 16, ks * 16);
    mma(acc[0], x[ks], b[0], b[1]);
    mma(acc[1], x[ks], b[2], b[3]);
  }
}

// acc (the DZ / 8 C tiles of a DZ-wide output) += the chunk's A fragment a
// times the B rows W (n = state, k = hidden, pitch P) at hidden chunk c.
template <int DZ>
__device__ __forceinline__ void chunk_acc(float (&acc)[DZ / 8][4], const uint32_t (&a)[4], const __nv_bfloat16* W,
                                          int P, int c) {
#pragma unroll
  for (int nt = 0; nt < DZ / 8; nt += 2) {
    uint32_t b[4];
    load_b2(b, W, P, nt * 8, c * 16);
    mma(acc[nt], a, b[0], b[1]);
    mma(acc[nt + 1], a, b[2], b[3]);
  }
}

// A DZ-wide f32 vector in C layout (DZ / 8 tiles) as DZ / 16 A fragments.
template <int DZ>
__device__ __forceinline__ void vec_to_a(uint32_t (&a)[DZ / 16][4], const float (&v)[DZ / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < DZ / 16; ++ks) c_to_a(a[ks], v[2 * ks], v[2 * ks + 1]);
}

// A thread's private f32 slot in shared memory for element e (0..7) of hidden
// chunk c of m16 tile mt: each warp's region holds 2 * NCH * 8 * 32 floats,
// read back by the lane that wrote it (no bank conflicts, layout-agnostic).
__device__ __forceinline__ float* priv(float* warp_base, int nch, int mt, int c, int e) {
  return warp_base + ((size_t)((mt * nch + c) * 8 + e) << 5) + lane_id();
}

}  // namespace bf16
}  // namespace cnf
