// Batched damped SPD solve x = -(H + diag(lam * diag(H) + 1e-12))^-1 b of B
// independent systems, f32, for sm_90a. One thread block of 512 threads
// solves one system.
//
// Replaces the TPU kernel cerberus_tpu/ops/pallas_kernels.py::cholesky_solve
// (Pallas body `_chol_solve_kernel` with `_tile_cholesky`,
// `_trsm_right_lower_t`, `_trsv_lower`, `_trsv_upper`). The TPU kernel pads
// n to a multiple of 128 and factors in 128-wide panels so that each
// system's whole matrix sits in VMEM (590 KB at n = 384); both are artefacts
// of the TPU's memory and matrix unit and are not carried over. The damping
// is NOT Jacobi-equilibrated (unlike ops/solver._damped_solve_schur), as in
// the TPU kernel. H is (B, n, n) row-major and contiguous, b and x are
// (B, n), lam is (B,). Only H's lower triangle is read, once.
//
// Prologue, as the load of the tiles: lower(H) + diag(lam * diag(H) +
// 1e-12), and v = -b. Then the blocked factor and both substitutions of
// blocked_cholesky.cuh (shared with lane_cholesky.cu), in 32-wide tiles:
// resident in shared memory up to n = 320, streamed above from the
// workspace W that the Python wrapper allocates, with the panel being solved
// and the next in shared memory. At n = 384 the triangle is 12 x 13 / 2
// tiles of 4 KB, 319,488 B (it stays in the 50 MB L2 cache), the two panels
// 98,304 B.
//
// Bound at the TPU kernel's largest tested shape (B = 3, n = 384) on an
// H100 SXM (700 W): H's lower triangle, b, lam and x are
// 4 * (B n(n+1)/2 + 2 B n + B) B = 0.89 MB, ~0.27 us at 3.35 TB/s;
// n^3/3 + 2 n^2 + 2 n flops per system, 57 MFLOP in all, ~0.85 us at
// 67 TFLOP/s of f32: bound by the operations. Three systems fill 3 SMs of
// 132, whose own rate is 3/132 of that: 37 us.

#include <cuda_runtime.h>

#include "blocked_cholesky.cuh"

namespace {

struct Damped {
  const float* lam;
  float lam_s;
  __device__ Damped at(size_t sys) const { return {lam, lam[sys]}; }
  __device__ float diag(float h) const { return h + (lam_s * h + 1e-12f); }
  __device__ float rhs(float b) const { return -b; }
};

}  // namespace

extern "C" {

// Launch the kernel on `stream` of `device` without synchronising, with the
// tile plan of ops/lane_cholesky.py::tile_plan (nb, resident, panel_in_smem,
// smem bytes). W: workspace of the streamed tiles, NULL when resident.
// Return the CUDA error code of the launch (0 when it was accepted).
int damped_cholesky_solve_f32(const float* H, const float* b,
                              const float* lam, float* x, float* W, int batch,
                              int n, int nb, int resident, int panel_in_smem,
                              int smem, int device, void* stream) {
  return blocked_cholesky::launch<float, 32>(
      H, b, Damped{lam, 0.0f}, x, W, batch, n, nb, resident, panel_in_smem,
      smem, device, stream);
}

const char* damped_cholesky_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
