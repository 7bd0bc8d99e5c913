// Batched Cholesky solve x = A^-1 b of B independent SPD systems, f32 and
// f64, for sm_90a. One thread block of 512 threads solves one system.
//
// Replaces the TPU kernel cerberus_tpu/ops/lane_cholesky.py::
// lane_cholesky_solve (Pallas body `_kernel`), which the LM solve
// (ops/solver.py) calls once per iteration on the reduced Schur system S
// (n = 222) of every window: f32 on the batched path (B = 128) and in
// solve_window (B = 1), f64 in the streaming estimator (B = 1). The TPU
// kernel puts the batch on the 128-wide lane axis and pads n to 32-wide
// slabs; both are artefacts of the TPU's vector unit and are not carried
// over. A is (B, n, n) row-major and contiguous (only its lower triangle is
// read), b and x are (B, n).
//
// The device body is blocked_cholesky.cuh (shared with cholesky_solve.cu),
// which says what its design does against the column kernel's costs. Tiles
// of 32 in f32 and 16 in f64 (in 32-wide tiles the f64 triangle at n = 222
// would need 229,376 B, over a block's 232,448 B with the vectors): the
// factor stays resident in shared memory up to n = 320 in f32 (116,480 B at
// n = 222) and n = 224 in f64 (218,624 B at n = 222); above that the tiles
// are streamed from a workspace W that the Python wrapper allocates
// (ops/lane_cholesky.py::tile_plan).
//
// Bound at the paths' shapes on an H100 SXM (700 W): the lower triangle of
// A, b and x, es * (B n(n+1)/2 + 2 B n) bytes, over 3.35 TB/s, against
// B (n^3/3 + 2 n^2) flops over the type's rate outside the tensor cores:
//   * f32, B = 128, n = 222: 12.9 MB, 3.9 us; 0.48 GFLOP at 67 TFLOP/s,
//     7.2 us: bound by the operations; at B = 1 (solve_window) 0.056 us;
//   * f64, B = 1, n = 222: 0.2 MB, 0.06 us; 3.7 MFLOP at 34 TFLOP/s,
//     0.11 us: bound by the operations. One system fills one SM of 132,
//     whose own f64 rate is 1/132 of that: 14 us.

#include <cuda_runtime.h>

#include "blocked_cholesky.cuh"

namespace bc = blocked_cholesky;

extern "C" {

// Launch the kernel on `stream` of `device` without synchronising, with the
// tile plan of ops/lane_cholesky.py::tile_plan (nb, resident, panel_in_smem,
// smem bytes). W: workspace of the streamed tiles, NULL when resident.
// Return the CUDA error code of the launch (0 when it was accepted).
int lane_cholesky_solve_f32(const float* A, const float* b, float* x,
                            float* W, int batch, int n, int nb, int resident,
                            int panel_in_smem, int smem, int device,
                            void* stream) {
  return bc::launch<float, 32>(A, b, bc::Undamped<float>{}, x, W, batch, n,
                               nb, resident, panel_in_smem, smem, device,
                               stream);
}

int lane_cholesky_solve_f64(const double* A, const double* b, double* x,
                            double* W, int batch, int n, int nb, int resident,
                            int panel_in_smem, int smem, int device,
                            void* stream) {
  return bc::launch<double, 16>(A, b, bc::Undamped<double>{}, x, W, batch, n,
                                nb, resident, panel_in_smem, smem, device,
                                stream);
}

const char* lane_cholesky_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
