// Column Cholesky factor and both substitutions of one SPD system by one
// thread block: the device body of lane_cholesky.cu and cholesky_solve.cu.
// Each of those kernels loads its system into L and v, then calls
// factor_solve; they differ in where L lives (shared memory, whole or
// packed; a global workspace) and in what they do before the factor.
//
//   * L holds the lower triangle of the system on entry and its Cholesky
//     factor on exit. Element (r, c), c <= r, sits at Layout::at(r, c, n):
//     Full is the row-major n x n matrix, Packed the lower triangle row by
//     row (r(r+1)/2 + c).
//   * col (n) and v (n) are in shared memory; v holds the right-hand side
//     on entry. x (n) is written once, by warp 0.
//   * Right-looking, one column per step: scale column j into col, then a
//     rank-1 update of the trailing lower triangle (one warp per row, lanes
//     along the row), __syncthreads() between steps. Then forward and back
//     substitution by one warp. Only the lower triangle is read or written.

#pragma once

#include <cuda_runtime.h>

namespace column_cholesky {

struct Full {
  __host__ __device__ __forceinline__ static int at(int r, int c, int n) {
    return r * n + c;
  }
};

struct Packed {
  __host__ __device__ __forceinline__ static int at(int r, int c, int) {
    return r * (r + 1) / 2 + c;
  }
};

template <typename T>
__device__ __forceinline__ T sqrt_t(T v);
template <>
__device__ __forceinline__ float sqrt_t<float>(float v) { return sqrtf(v); }
template <>
__device__ __forceinline__ double sqrt_t<double>(double v) { return sqrt(v); }

// The caller has filled L and v and synchronised the block.
template <typename T, typename Layout>
__device__ void factor_solve(T* L, T* col, T* v, T* __restrict__ x, int n) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // ---- factor: L L^T, right-looking, lower triangle only ----
  for (int j = 0; j < n; ++j) {
    const T d = sqrt_t<T>(L[Layout::at(j, j, n)]);
    for (int i = j + tid; i < n; i += blockDim.x)
      col[i] = (i == j) ? d : L[Layout::at(i, j, n)] / d;
    __syncthreads();
    for (int i = j + tid; i < n; i += blockDim.x)
      L[Layout::at(i, j, n)] = col[i];
    for (int r = j + 1 + warp; r < n; r += nwarps) {
      const T lr = col[r];
      T* Lr = L + Layout::at(r, 0, n);
      for (int c = j + 1 + lane; c <= r; c += 32) Lr[c] -= lr * col[c];
    }
    __syncthreads();
  }

  // ---- forward (L y = v) and back (L^T x = y) substitution, one warp ----
  if (warp == 0) {
    for (int j = 0; j < n; ++j) {
      const T yj = v[j] / L[Layout::at(j, j, n)];
      __syncwarp();
      for (int i = j + 1 + lane; i < n; i += 32)
        v[i] -= L[Layout::at(i, j, n)] * yj;
      if (lane == 0) v[j] = yj;
      __syncwarp();
    }
    for (int j = n - 1; j >= 0; --j) {
      const T xj = v[j] / L[Layout::at(j, j, n)];
      __syncwarp();
      const T* Lj = L + Layout::at(j, 0, n);  // row j of L: column j of L^T
      for (int i = lane; i < j; i += 32) v[i] -= Lj[i] * xj;
      if (lane == 0) v[j] = xj;
      __syncwarp();
    }
    for (int i = lane; i < n; i += 32) x[i] = v[i];
  }
}

}  // namespace column_cholesky
