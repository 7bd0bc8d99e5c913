// Batched damped SPD solve x = -(H + diag(lam * diag(H) + 1e-12))^-1 b of B
// independent systems, f32, for sm_90a. One thread block solves one system.
//
// Replaces the TPU kernel cerberus_tpu/ops/pallas_kernels.py::cholesky_solve
// (Pallas body `_chol_solve_kernel` with `_tile_cholesky`,
// `_trsm_right_lower_t`, `_trsv_lower`, `_trsv_upper`). The TPU kernel pads
// n to a multiple of 128 and factors in 128-wide panels so that each
// system's whole matrix sits in VMEM (590 KB at n = 384); both are artefacts
// of the TPU's memory and matrix unit and are not carried over. The damping
// is NOT Jacobi-equilibrated (unlike ops/solver._damped_solve_schur), as in
// the TPU kernel. Here:
//
//   * H is (B, n, n) row-major and contiguous, b and x are (B, n), lam is
//     (B,). Only H's lower triangle is read, once.
//   * The damped lower triangle lives in a global workspace W (B, n(n+1)/2),
//     packed row by row (element (r, c), c <= r, at r(r+1)/2 + c), which the
//     Python wrapper allocates. n is not limited by shared memory: an f32
//     system at n = 384 is 589,824 B, over the 232,448 B a block may use on
//     sm_90. A block's triangle (295 KB at n = 384) stays in the 50 MB L2
//     cache while it is factored.
//   * Prologue: W = lower(H) + diag(lam * diag(H) + 1e-12), v = -b.
//   * Then the column Cholesky and both substitutions of
//     column_cholesky.cuh (shared with lane_cholesky.cu) on W, with the
//     column and the right-hand side in shared memory.
//
// Bound at the TPU kernel's largest tested shape (B = 3, n = 384) on an
// H100 SXM: H's lower triangle, b, lam and x are 4 * (B n(n+1)/2 + 2 B n + B)
// B = 0.89 MB, ~0.27 us at 3.35 TB/s; n^3/3 + 2 n^2 + 2 n flops per system,
// 57 MFLOP in all, ~0.85 us at 67 TFLOP/s of f32: bound by the operations.
// This design is latency-bound on its n serial column steps (two block-wide
// barriers each, every element through L2) and 2n serial substitution steps,
// with one block per system on 132 SMs.

#include <cuda_runtime.h>

#include "column_cholesky.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
damped_cholesky_solve_kernel(const float* __restrict__ H,
                             const float* __restrict__ b,
                             const float* __restrict__ lam,
                             float* __restrict__ x, float* __restrict__ W,
                             int n) {
  using column_cholesky::Packed;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* col = reinterpret_cast<float*>(smem_raw);  // column j of L
  float* v = col + n;                               // -b, then y, then x

  const size_t sys = blockIdx.x;
  const float* Hs = H + sys * n * n;
  float* L = W + sys * ((size_t)n * (n + 1) / 2);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float lam_s = lam[sys];

  // ---- damping prologue: lower triangle of H, diagonal damped ----
  for (int r = warp; r < n; r += nwarps) {
    const float* Hr = Hs + (size_t)r * n;
    float* Lr = L + Packed::at(r, 0, n);
    for (int c = lane; c <= r; c += 32) {
      const float h = Hr[c];
      Lr[c] = (c == r) ? h + (lam_s * h + 1e-12f) : h;
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = -b[sys * n + i];
  __syncthreads();

  column_cholesky::factor_solve<float, Packed>(L, col, v, x + sys * n, n);
}

}  // namespace

extern "C" {

// Launch the kernel on `stream` of `device` without synchronising. W is a
// workspace of batch * n(n+1)/2 floats. Return the CUDA error code of the
// launch (0 when it was accepted).
int damped_cholesky_solve_f32(const float* H, const float* b,
                              const float* lam, float* x, float* W, int batch,
                              int n, int device, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 2 * (size_t)n * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(damped_cholesky_solve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  damped_cholesky_solve_kernel<<<batch, kThreads, smem,
                                 (cudaStream_t)stream>>>(H, b, lam, x, W, n);
  return (int)cudaGetLastError();
}

const char* damped_cholesky_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
