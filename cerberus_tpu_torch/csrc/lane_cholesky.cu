// Batched Cholesky solve x = A^-1 b of B independent SPD systems, f32, for
// sm_90a. One thread block solves one system.
//
// Replaces the TPU kernel cerberus_tpu/ops/lane_cholesky.py::
// lane_cholesky_solve (Pallas body `_kernel`), which the batched LM solve
// (ops/solver.py::solve_window_batched) calls once per iteration on the
// reduced Schur system S (n = 222) of every window. The TPU kernel puts the
// batch on the 128-wide lane axis and pads n to 32-wide slabs; both are
// artefacts of the TPU's vector unit and are not carried over. Here:
//
//   * A is (B, n, n) row-major and contiguous, b and x are (B, n).
//   * The whole f32 matrix lives in dynamic shared memory: n*n floats plus
//     two n-vectors (the current column and the right-hand side), i.e.
//     (n*n + 2n) * 4 bytes = 198,912 B at n = 222. A block may use at most
//     232,448 B (227 KB) on sm_90, so n <= 240; the Python wrapper refuses
//     larger n. Above 48 KB the launch needs the opt-in attribute, which the
//     entry point sets before every launch.
//   * Right-looking Cholesky, one column per step: scale column j, then a
//     rank-1 update of the trailing lower triangle (one warp per row, lanes
//     along the row), __syncthreads() between steps. Then forward and back
//     substitution on the same shared factor, by one warp. Only the lower
//     triangle of A is read, once; x is written once; L never leaves
//     shared memory.
//
// Bound at the main path's shape (B = 128, n = 222, f32) on an H100 SXM:
// the lower triangle of A plus b and x is 4 * (B n(n+1)/2 + 2 B n) B =
// 12.9 MB, ~3.9 us at 3.35 TB/s; the factorization and both substitutions
// are n^3/3 + 2 n^2 flops per system, ~0.48 GFLOP in all, ~7.2 us at the
// 67 TFLOP/s of f32 outside the tensor cores, so the bound is set by the
// operations. This design does not come near it: it is latency-bound on
// its 222 serial column steps per block (two block-wide barriers each) and
// on the 2 x 222 serial substitution steps, with only B = 128 blocks for
// 132 SMs. Blocked panels, wgmma and TMA are for later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cholesky_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                      float* __restrict__ x, int n) {
  extern __shared__ float smem[];
  float* L = smem;         // n * n, row-major; the lower triangle ends as L
  float* col = L + n * n;  // column j of L during step j
  float* v = col + n;      // b, overwritten by y, then by x

  const size_t sys = blockIdx.x;
  const float* As = A + sys * n * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // only the lower triangle is read (the factor never touches the upper),
  // each row's run by one warp, coalesced
  for (int r = warp; r < n; r += nwarps)
    for (int c = lane; c <= r; c += 32) L[r * n + c] = As[r * n + c];
  for (int i = tid; i < n; i += blockDim.x) v[i] = b[sys * n + i];
  __syncthreads();

  // ---- factor: A = L L^T, right-looking, lower triangle only ----
  for (int j = 0; j < n; ++j) {
    const float d = sqrtf(L[j * n + j]);
    for (int i = j + tid; i < n; i += blockDim.x)
      col[i] = (i == j) ? d : L[i * n + j] / d;
    __syncthreads();
    for (int i = j + tid; i < n; i += blockDim.x) L[i * n + j] = col[i];
    for (int r = j + 1 + warp; r < n; r += nwarps) {
      const float lr = col[r];
      float* Lr = L + r * n;
      for (int c = j + 1 + lane; c <= r; c += 32) Lr[c] -= lr * col[c];
    }
    __syncthreads();
  }

  // ---- forward (L y = b) and back (L^T x = y) substitution, one warp ----
  if (warp == 0) {
    for (int j = 0; j < n; ++j) {
      const float yj = v[j] / L[j * n + j];
      __syncwarp();
      for (int i = j + 1 + lane; i < n; i += 32) v[i] -= L[i * n + j] * yj;
      if (lane == 0) v[j] = yj;
      __syncwarp();
    }
    for (int j = n - 1; j >= 0; --j) {
      const float xj = v[j] / L[j * n + j];
      __syncwarp();
      const float* Lj = L + j * n;  // row j of L is column j of L^T
      for (int i = lane; i < j; i += 32) v[i] -= Lj[i] * xj;
      if (lane == 0) v[j] = xj;
      __syncwarp();
    }
    for (int i = lane; i < n; i += 32) x[sys * n + i] = v[i];
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` of `device` without synchronising.
// Returns the CUDA error code of the launch (0 when it was accepted).
int lane_cholesky_solve_f32(const float* A, const float* b, float* x,
                            int batch, int n, int device, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ((size_t)n * n + 2 * (size_t)n) * sizeof(float);
  err = cudaFuncSetAttribute(cholesky_solve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cholesky_solve_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      A, b, x, n);
  return (int)cudaGetLastError();
}

const char* lane_cholesky_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
