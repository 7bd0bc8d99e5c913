// Batched Cholesky solve x = A^-1 b of B independent SPD systems, f32 and
// f64, for sm_90a. One thread block solves one system.
//
// Replaces the TPU kernel cerberus_tpu/ops/lane_cholesky.py::
// lane_cholesky_solve (Pallas body `_kernel`), which the batched LM solve
// (ops/solver.py::solve_window_batched) calls once per iteration on the
// reduced Schur system S (n = 222) of every window. The TPU kernel puts the
// batch on the 128-wide lane axis and pads n to 32-wide slabs; both are
// artefacts of the TPU's vector unit and are not carried over. Here:
//
//   * A is (B, n, n) row-major and contiguous, b and x are (B, n).
//   * The factor lives in dynamic shared memory, with two n-vectors (the
//     current column and the right-hand side). A block may use at most
//     232,448 B (227 KB) on sm_90, and the Python wrapper refuses an n whose
//     layout needs more. Above 48 KB the launch needs the opt-in attribute,
//     which the entry point sets before every launch.
//       - f32 keeps the whole n x n matrix, (n*n + 2n) * 4 B = 198,912 B at
//         n = 222, so n <= 240.
//       - f64 keeps only the lower triangle, packed row by row (element
//         (r, c), c <= r, at r(r+1)/2 + c): (n(n+1)/2 + 2n) * 8 B =
//         201,576 B at n = 222, so n <= 238. The full f64 matrix would need
//         397,824 B.
//   * Right-looking Cholesky, one column per step, then forward and back
//     substitution on the same shared factor by one warp: the device body
//     column_cholesky.cuh, shared with cholesky_solve.cu. Only the lower
//     triangle of A is read, once; x is written once; L never leaves
//     shared memory.
//
// Bound at the main path's shapes on an H100 SXM:
//   * f32, B = 128, n = 222 (solve_window_batched): the lower triangle of A
//     plus b and x is 4 * (B n(n+1)/2 + 2 B n) B = 12.9 MB, ~3.9 us at
//     3.35 TB/s; the factorization and both substitutions are
//     n^3/3 + 2 n^2 flops per system, ~0.48 GFLOP in all, ~7.2 us at the
//     67 TFLOP/s of f32 outside the tensor cores: bound by the operations.
//   * f64, B = 1, n = 222 (the streaming estimator): 8 * (n(n+1)/2 + 2n) B =
//     0.2 MB, ~0.06 us; 3.7 MFLOP at 34 TFLOP/s of f64, ~0.11 us: bound by
//     the operations.
// This design does not come near either bound: it is latency-bound on its
// n serial column steps per block (two block-wide barriers each) and on the
// 2n serial substitution steps, and a batch of one fills one SM of 132.
// Blocked panels, wgmma and TMA are for later.

#include <cuda_runtime.h>

#include "column_cholesky.cuh"

namespace {

using column_cholesky::Full;
using column_cholesky::Packed;

constexpr int kThreads = 256;

template <typename T, typename Layout>
__global__ void __launch_bounds__(kThreads)
cholesky_solve_kernel(const T* __restrict__ A, const T* __restrict__ b,
                      T* __restrict__ x, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* L = reinterpret_cast<T*>(smem_raw);  // the lower triangle ends as L
  T* col = L + Layout::at(n, 0, n);       // column j of L during step j
  T* v = col + n;                         // b, overwritten by y, then by x

  const size_t sys = blockIdx.x;
  const T* As = A + sys * n * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // only the lower triangle is read (the factor never touches the upper),
  // each row's run by one warp, coalesced
  for (int r = warp; r < n; r += nwarps)
    for (int c = lane; c <= r; c += 32)
      L[Layout::at(r, c, n)] = As[(size_t)r * n + c];
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = b[sys * n + i];
  __syncthreads();

  column_cholesky::factor_solve<T, Layout>(L, col, v, x + sys * n, n);
}

template <typename T, typename Layout>
int launch(const T* A, const T* b, T* x, int batch, int n, int device,
           void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ((size_t)Layout::at(n, 0, n) + 2 * n) * sizeof(T);
  err = cudaFuncSetAttribute(cholesky_solve_kernel<T, Layout>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cholesky_solve_kernel<T, Layout>
      <<<batch, kThreads, smem, (cudaStream_t)stream>>>(A, b, x, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the kernel on `stream` of `device` without synchronising.
// Return the CUDA error code of the launch (0 when it was accepted).
int lane_cholesky_solve_f32(const float* A, const float* b, float* x,
                            int batch, int n, int device, void* stream) {
  return launch<float, Full>(A, b, x, batch, n, device, stream);
}

int lane_cholesky_solve_f64(const double* A, const double* b, double* x,
                            int batch, int n, int device, void* stream) {
  return launch<double, Packed>(A, b, x, batch, n, device, stream);
}

const char* lane_cholesky_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
