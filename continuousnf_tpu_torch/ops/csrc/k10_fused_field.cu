// K10: one evaluation of the TRAIN-mode field of a 2-layer tanh MLP with one
// Hutchinson VJP probe, per sample:
//   h  = tanh(z W1 + b1)                      (H)
//   y  = tanh(h W2 + b2)                      (dz)
//   g1 = ((eps * (1 - y^2)) W2^T) * (1 - h^2)  (H)
//   eJ = g1 W1^T                              (dz, eps^T J)
//   outputs y (B, dz), tr = <eJ, eps>, ||y|| and ||eJ|| (B each).
//
// Replaces the TPU kernel continuousnf_tpu/ops/fused_dynamics.py::_fused_forward
// (pl.pallas_call at :93) with the body _kernel (:57-71).  It runs for every
// stage of a TRAIN solve that the whole-solve kernels do not take: the DIRECT
// adjoint, fixed steps, float64 (core/dynamics.py::f_train_fused).  Its
// backward is the plain version's VJP (ops/fused_dynamics.py), as the TPU
// kernel's is.
//
// What bounds it on the H100: launch latency.  A sample costs 4 dz H FMA
// (3,072 at dz = 16, H = 48): at B = 4096 that is 25 MFLOP, 0.4 us at the f32
// rate, and the bytes (z and eps in, y and three scalars out, the weights
// once) take 0.25 us at 3.35 TB/s; a launch costs a few us.  So the design is
// simple and keeps every intermediate out of device memory:
//   * one warp per sample, eight warps per block, a warp striding over samples
//     when B exceeds the resident grid; the tail is masked by the loop bound
//     (no padding of the batch, unlike the TPU's 1024-sample tiles);
//   * each of the four products gives each lane one output element (h_j and
//     g1_j: lanes over H; y_k and eJ_i: lanes over dz) and loops over the
//     contraction, so no product needs a cross-lane sum; only tr, ||y||^2
//     and ||eJ||^2 are warp-reduced.  A thread per sample would leave 32
//     blocks of the 132 SMs busy at B = 4096 and serialise 3,072 dependent
//     FMA per thread; a warp per sample runs 160 per lane at the flagship;
//   * W1, b1, W2, b2 are copied into shared memory once per block, the
//     weight matrices at an odd row pitch (H | 1 and dz | 1): the products
//     read W1 and W2 along rows (lanes on consecutive columns) and along
//     columns (lanes on consecutive rows), and an odd pitch makes both
//     conflict-free, so no transposed copy is kept;
//   * the sample's z, eps, eps (1 - y^2) and h (then g1) sit in a per-warp
//     slice of shared memory, read as broadcasts.
// Coverage: any B, any dz and H whose weights and the eight warps' slices fit
// in a block's 227 KB (cnf_k10_smem_bytes; about 200 KB of weights); larger
// nets raise in the wrapper, naming "K10 shape variants".
// Precision: FMA on the CUDA cores in the input's type, float or double
// (the TPU op is dtype-generic); tanhf / tanh, no fast-math intrinsic, no
// TF32, no tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float tanh_(float x) { return tanhf(x); }
__device__ __forceinline__ double tanh_(double x) { return tanh(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Elements of shared memory a block uses: W1 (dz rows at pitch H | 1), b1,
// W2 (H rows at pitch dz | 1), b2, and per warp z, eps, u = eps (1 - y^2)
// (dz each) and h, later g1 (H).
size_t smem_elems(int dz, int H) {
  return (size_t)dz * (H | 1) + H + (size_t)H * (dz | 1) + dz + (size_t)kWarps * (3 * dz + H);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k10_fused_field(const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
                    const T* __restrict__ b2, const T* __restrict__ z, const T* __restrict__ eps,
                    T* __restrict__ y, T* __restrict__ tr, T* __restrict__ e_rate,
                    T* __restrict__ n_rate, int B, int dz, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw1 = reinterpret_cast<T*>(smem_raw);
  const int pH = H | 1, pD = dz | 1;
  T* sb1 = sw1 + (size_t)dz * pH;
  T* sw2 = sb1 + H;
  T* sb2 = sw2 + (size_t)H * pD;
  for (int idx = threadIdx.x; idx < dz * H; idx += kThreads) {
    const int i = idx / H, j = idx - i * H;  // w1 is (dz, H) row-major
    sw1[i * pH + j] = w1[idx];
    const int r = idx / dz, c = idx - r * dz;  // w2 is (H, dz) row-major
    sw2[r * pD + c] = w2[idx];
  }
  for (int j = threadIdx.x; j < H; j += kThreads) sb1[j] = b1[j];
  for (int k = threadIdx.x; k < dz; k += kThreads) sb2[k] = b2[k];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* zb = sb2 + dz + (size_t)warp * (3 * dz + H);
  T* eb = zb + dz;
  T* ub = eb + dz;
  T* hb = ub + dz;
  for (long long b = (long long)blockIdx.x * kWarps + warp; b < B; b += (long long)gridDim.x * kWarps) {
    const T* zr = z + b * dz;
    const T* er = eps + b * dz;
    for (int i = lane; i < dz; i += 32) {
      zb[i] = zr[i];
      eb[i] = er[i];
    }
    __syncwarp();
    // h_j = tanh(b1_j + sum_i z_i W1[i, j])
    for (int j = lane; j < H; j += 32) {
      T a = sb1[j];
      for (int i = 0; i < dz; ++i) a = fma_(zb[i], sw1[i * pH + j], a);
      hb[j] = tanh_(a);
    }
    __syncwarp();
    // y_k = tanh(b2_k + sum_j h_j W2[j, k]); u_k = eps_k (1 - y_k^2)
    T ysq = T(0);
    for (int k = lane; k < dz; k += 32) {
      T a = sb2[k];
      for (int j = 0; j < H; ++j) a = fma_(hb[j], sw2[j * pD + k], a);
      const T yk = tanh_(a);
      y[b * dz + k] = yk;
      ysq = fma_(yk, yk, ysq);
      ub[k] = eb[k] * (T(1) - yk * yk);
    }
    __syncwarp();
    // g1_j = (sum_k u_k W2[j, k]) (1 - h_j^2), in place of h_j
    for (int j = lane; j < H; j += 32) {
      T a = T(0);
      for (int k = 0; k < dz; ++k) a = fma_(ub[k], sw2[j * pD + k], a);
      const T h = hb[j];
      hb[j] = a * (T(1) - h * h);
    }
    __syncwarp();
    // eJ_i = sum_j g1_j W1[i, j]; tr = <eJ, eps>
    T t = T(0), nsq = T(0);
    for (int i = lane; i < dz; i += 32) {
      T a = T(0);
      for (int j = 0; j < H; ++j) a = fma_(hb[j], sw1[i * pH + j], a);
      t = fma_(a, eb[i], t);
      nsq = fma_(a, a, nsq);
    }
    t = warp_sum(t);
    ysq = warp_sum(ysq);
    nsq = warp_sum(nsq);
    if (lane == 0) {
      tr[b] = t;
      e_rate[b] = sqrt_(ysq);
      n_rate[b] = sqrt_(nsq);
    }
    __syncwarp();  // the warp's slice is rewritten for its next sample
  }
}

template <typename T>
int launch(const T* w1, const T* b1, const T* w2, const T* b2, const T* z, const T* eps, T* y, T* tr,
           T* e_rate, T* n_rate, int B, int dz, int H, void* stream) {
  if (B < 1 || dz < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * smem_elems(dz, H);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(k10_fused_field<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k10_fused_field<T>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = ((long long)B + kWarps - 1) / kWarps;
  const int grid = (int)(want < (long long)sms * per_sm ? want : (long long)sms * per_sm);
  k10_fused_field<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(w1, b1, w2, b2, z, eps, y, tr, e_rate,
                                                                     n_rate, B, dz, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes, for elements of `elem_bytes`.
extern "C" long long cnf_k10_smem_bytes(int dz, int H, int elem_bytes) {
  return (long long)elem_bytes * (long long)smem_elems(dz, H);
}

// w1 (dz, H), b1 (H), w2 (H, dz), b2 (dz), z and eps (B, dz), all row-major
// and contiguous; writes y (B, dz), tr, e_rate and n_rate (B).  Returns the
// launch's cudaError_t.
extern "C" int cnf_k10_fused_field_f32(const float* w1, const float* b1, const float* w2, const float* b2,
                                       const float* z, const float* eps, float* y, float* tr, float* e_rate,
                                       float* n_rate, int B, int dz, int H, void* stream) {
  return launch(w1, b1, w2, b2, z, eps, y, tr, e_rate, n_rate, B, dz, H, stream);
}

extern "C" int cnf_k10_fused_field_f64(const double* w1, const double* b1, const double* w2, const double* b2,
                                       const double* z, const double* eps, double* y, double* tr,
                                       double* e_rate, double* n_rate, int B, int dz, int H, void* stream) {
  return launch(w1, b1, w2, b2, z, eps, y, tr, e_rate, n_rate, B, dz, H, stream);
}
