// Blocked Cholesky factor and both substitutions of one SPD system per
// thread block of 512 threads, for sm_90a: the device body of
// lane_cholesky.cu (f32, f64) and cholesky_solve.cu (damped, f32).
//
// Replaces, with those two files, the TPU kernels
// cerberus_tpu/ops/lane_cholesky.py::lane_cholesky_solve (body `_kernel`)
// and cerberus_tpu/ops/pallas_kernels.py::cholesky_solve (body
// `_chol_solve_kernel`).
//
// Storage. n is padded to n_pad = nt * NB (the padding is the identity, its
// right-hand side 0). The lower triangle is kept as nt(nt+1)/2 tiles of
// NB x NB, block-column by block-column ((J,J), (J+1,J), ..., (nt-1,J)), so
// that a panel is one contiguous run; inside a tile, element (r, c) sits at
// c * NB + r (column-major). Once factored, a diagonal tile holds the
// inverse M of its factor instead, column-major in its lower half and as a
// mirror (M[r][c] at r * NB + c) in its upper half. With this layout a
// warp's shared-memory accesses are runs of consecutive elements or
// broadcasts, except where noted (the load's stores, M's column-major
// writes), and no padding is needed. The tiles live either in shared memory
// (resident: a block may use 232,448 B on sm_90, which holds f32 up to
// n = 320 with NB = 32 and f64 up to n = 224 with NB = 16) or in a global
// workspace (streamed, any n), with the panel being solved and the next
// one in shared memory when they fit. ops/lane_cholesky.py::tile_plan
// makes that choice and sizes the shared memory; the kernels take its
// numbers.
//
// Bound on an H100 SXM (700 W): es * (n(n+1)/2 + 2n) bytes per system over
// 3.35 TB/s against n^3/3 + 2 n^2 flops over 67 TFLOP/s (f32) or 34
// TFLOP/s (f64; the update runs on FMA, not on the FP64 tensor cores): at
// the paths' shapes (n = 222; f32 B = 128, f64 B = 1) 7.2 us and 0.11 us,
// bound by the operations. One system fills one SM of 132, so at B = 1 the
// SM's own f64 rate (1/132 of the card's) allows 14 us.
//
// What the column kernel this replaced lost its time to, and the answer:
//   * 2n block barriers (one column per step): nt panel steps of three
//     barriers each (7 steps at n = 222 in f32, 14 in f64, 12 at n = 384).
//     Look-ahead of one: once panel K is solved, the diagonal tile K+1 is
//     updated first, then warp 0 factors it while 15 warps update the rest.
//   * the diagonal NB x NB tile is factored by one warp in registers (lane r
//     holds row r), column by column, no block barrier: the pivot comes by
//     shuffle, its reciprocal square root is one operation, the chain from
//     one pivot to the next passes through no memory, and each column is
//     published in shared memory and read back as broadcast vectors;
//   * the panel below it is solved (TRSM) one row per thread, with the
//     diagonal tile's columns read as broadcast vectors;
//   * load, FMA, store per trailing element per column: the trailing update
//     (SYRK/GEMM) gives each thread a 4 x 4 micro-tile of one tile, so each
//     panel element it loads (16-byte vector loads) feeds 4 FMAs, and each
//     trailing element is read and written once per panel step. In the
//     streamed case that is one L2 round trip per panel step instead of one
//     per column; the panel, the operand that is reused, sits in shared
//     memory, and the trailing tile goes straight to registers, so a ring of
//     shared buffers would add a copy without reuse;
//   * 2n serial substitution steps on one warp: 2 nt tile steps, in each of
//     which one warp applies the diagonal tile's inverse M (a matrix-vector
//     product, no serial chain), then all threads apply that tile's
//     matrix-vector product to the other rows (forward: one thread per row;
//     back: one thread per column, its reads skewed so that a warp's are
//     conflict-free). The inverses are made after the factor, one warp per
//     diagonal tile at once;
//   * 8 warps: 16 here.
// Only the lower triangle of A is read, once; x is written once.
// What still holds it back: while one warp factors a diagonal tile (NB
// dependent steps of shuffle, reciprocal square root and FMA), the others
// can only update; and a batch of one system fills one SM of 132.

#pragma once

#include <cuda_runtime.h>

namespace blocked_cholesky {

constexpr int kThreads = 512;
constexpr int kMaxDevices = 64;

// 1 / sqrt(v): one MUFU op in f32 (max 2 ulp), CUDA's rsqrt in f64 (max
// 1 ulp); the pivot chain then waits on no sqrt and no division
template <typename T>
__device__ __forceinline__ T rsqrt_t(T v);
template <>
__device__ __forceinline__ float rsqrt_t<float>(float v) { return rsqrtf(v); }
template <>
__device__ __forceinline__ double rsqrt_t<double>(double v) { return rsqrt(v); }

// Four consecutive elements through 16-byte accesses; p is 16-byte aligned.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// Index of tile (I, J), J <= I, in the tile-major triangle.
__host__ __device__ __forceinline__ int tile_index(int I, int J, int nt) {
  return J * nt - J * (J - 1) / 2 + (I - J);
}

// Tile t of the tile-major triangle -> its block row I and column J.
__device__ __forceinline__ void tile_decode(int t, int nt, int& I, int& J) {
  J = 0;
  while (t >= nt - J) t -= nt - J++;
  I = J + t;
}

// The undamped system (lane_cholesky.cu).
template <typename T>
struct Undamped {
  __device__ Undamped at(size_t) const { return *this; }
  __device__ T diag(T h) const { return h; }
  __device__ T rhs(T b) const { return b; }
};

// Fill the tiles with the lower triangle of the row-major n x n system A and
// v with its right-hand side, through pro (the damping, if any). The
// padding is the identity; the strictly upper half of a diagonal tile is 0.
// One warp per tile: each lane has its loads of A in flight (kLoadBatch at
// a time) before it stores any, and a warp reads 8 rows x 4 columns at a
// time (8 row segments of A; 4-way bank conflicts where it stores them
// along the tile's columns).
constexpr int kLoadBatch = 8;

template <typename T, int NB, typename Prologue>
__device__ void load_system(T* tiles, T* v, const T* __restrict__ A,
                            const T* __restrict__ b, const Prologue& pro,
                            int n, int nt) {
  constexpr int kPerLane = NB * NB / 32;
  constexpr int kBatch = kPerLane < kLoadBatch ? kPerLane : kLoadBatch;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int t = threadIdx.x >> 5; t < nt * (nt + 1) / 2; t += nwarps) {
    int I, J;
    tile_decode(t, nt, I, J);
    T* tile = tiles + (size_t)t * NB * NB;
#pragma unroll
    for (int g0 = 0; g0 < kPerLane; g0 += kBatch) {
      T val[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + u;         // 8 x 4 block g of the tile
        const int r = lane % 8 + 8 * (g % (NB / 8));
        const int c = lane / 8 + 4 * (g / (NB / 8));
        const int R = I * NB + r, C = J * NB + c;
        if (R < n && C < n)
          val[u] = C < R ? A[(size_t)R * n + C]
                         : (C == R ? pro.diag(A[(size_t)R * n + C]) : T(0));
        else
          val[u] = R == C ? T(1) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + u;
        const int r = lane % 8 + 8 * (g % (NB / 8));
        const int c = lane / 8 + 4 * (g / (NB / 8));
        tile[c * NB + r] = val[u];
      }
    }
  }
  for (int i = threadIdx.x; i < nt * NB; i += blockDim.x)
    v[i] = i < n ? pro.rhs(b[i]) : T(0);
}

// Warp 0: factor the diagonal tile D, lane r holding row r in registers
// and its diagonal element apart, in dg. Step j: every lane scales its
// L[r][j] by the pivot's reciprocal square root and subtracts its square
// from dg; the next pivot then comes from lane j+1 by shuffle at once, so
// the chain from one pivot to the next passes through no memory. Column j
// is published in D itself (its final place) and read back as broadcast
// vectors for the other updates. Then 1 / L[r][r] to inv_d[r].
template <typename T, int NB>
__device__ void factor_diagonal(T* D, T* inv_d) {
  const int r = threadIdx.x & 31;
  T a[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) a[c] = r < NB ? D[c * NB + r] : T(0);
  T dg = r < NB ? D[r * NB + r] : T(1);
  T myinv = T(1);
  T piv = __shfl_sync(0xffffffffu, dg, 0);
  T inv = rsqrt_t<T>(piv);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    // branch-free: lane j takes the pivot's square root, lanes below scale
    a[j] = (r == j ? piv : a[j]) * inv;
    myinv = r == j ? inv : myinv;
    const T dg_next = dg - a[j] * a[j];
    dg = r > j ? dg_next : dg;
    if (j + 1 < NB) {                   // the next pivot, ahead of the rest
      piv = __shfl_sync(0xffffffffu, dg, j + 1);
      inv = rsqrt_t<T>(piv);
    }
    if (r >= j && r < NB) D[j * NB + r] = a[j];
    __syncwarp();
#pragma unroll
    for (int c4 = (j + 1) / 4; c4 < NB / 4; ++c4) {
      T l[4];
      load4(D + j * NB + 4 * c4, l);    // L[4c4 .. 4c4+3][j]
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * c4 + u > j && r > 4 * c4 + u) a[4 * c4 + u] -= a[j] * l[u];
    }
  }
  if (r < NB) inv_d[r] = myinv;
}

// One warp: M = L^-1 of the factored diagonal tile D, lane c computing
// column c of M by forward substitution, column of L by column (L's
// elements read as broadcast vectors), then written over L: M in D's lower
// half (column-major, as L was) and its mirror in the upper half, M[r][c]
// at r * NB + c. Once the factor is done, one warp per diagonal tile; the
// substitutions use M in place of L's diagonal tiles, each orientation read
// along a warp's consecutive addresses.
template <typename T, int NB>
__device__ void invert_diagonal(T* D, const T* inv_d) {
  const int c = threadIdx.x & 31;
  T m[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) m[r] = r == c ? T(1) : T(0);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    m[k] *= inv_d[k];
#pragma unroll
    for (int r4 = (k + 1) / 4; r4 < NB / 4; ++r4) {
      T l[4];
      load4(D + k * NB + 4 * r4, l);    // L[4r4 .. 4r4+3][k]
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * r4 + u > k && k >= c) m[4 * r4 + u] -= l[u] * m[k];
    }
  }
  __syncwarp();                         // every lane has read L
  if (c < NB) {
#pragma unroll
    for (int r = 0; r < NB; ++r)
      if (r >= c) {
        D[c * NB + r] = m[r];             // M, column-major (strided)
        D[r * NB + c] = m[r];             // its mirror
      }
  }
}

// All threads: L_IK = A_IK L_KK^-T for the m tiles below the diagonal
// tile D of a panel, one row per thread (x L_KK^T = a, column by column).
template <typename T, int NB>
__device__ void solve_panel(T* D, const T* inv_d, int m) {
  for (int q = threadIdx.x; q < m * NB; q += blockDim.x) {
    T* P = D + (size_t)(1 + q / NB) * NB * NB;
    const int r = q % NB;
    T a[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) a[c] = P[c * NB + r];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      a[j] *= inv_d[j];
#pragma unroll
      for (int c4 = (j + 1) / 4; c4 < NB / 4; ++c4) {
        T l[4];
        load4(D + j * NB + 4 * c4, l);   // L[4c4 .. 4c4+3][j], a broadcast
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * c4 + u > j) a[4 * c4 + u] -= a[j] * l[u];
      }
    }
#pragma unroll
    for (int c = 0; c < NB; ++c) P[c * NB + r] = a[c];
  }
}

// A_IJ -= L_IK L_JK^T for the tiles t in [t_begin, t_end) of the trailing
// triangle K < J <= I < nt, counted block-column by block-column from
// (K+1, K+1); a 4 x 4 micro-tile per thread and item, threads tid of
// nthreads. panel[(I - K) * NB * NB] is L_IK. Block-column K+1 goes to
// out_col when it is given (the next panel's buffer), else in place.
template <typename T, int NB>
__device__ void update_tiles(T* tiles, const T* panel, T* out_col, int K,
                             int nt, int t_begin, int t_end, int tid,
                             int nthreads) {
  constexpr int MT = NB / 4;        // micro-tiles along a tile's edge
  const int m = nt - 1 - K;
  for (int it = t_begin * MT * MT + tid; it < t_end * MT * MT;
       it += nthreads) {
    const int mt = it % (MT * MT);
    const int mr = mt % MT, mc = mt / MT;
    int i, j;
    tile_decode(it / (MT * MT), m, i, j);
    if (i == j && mc > mr) continue;  // wholly above a diagonal tile's diagonal
    const int I = K + 1 + i, J = K + 1 + j;
    T* C = tiles + (size_t)tile_index(I, J, nt) * NB * NB;
    T* out = (out_col && j == 0) ? out_col + (size_t)i * NB * NB : C;
    T old[4][4];
#pragma unroll
    for (int v = 0; v < 4; ++v) load4(C + (4 * mc + v) * NB + 4 * mr, old[v]);
    const T* PI = panel + (size_t)(I - K) * NB * NB + 4 * mr;
    const T* PJ = panel + (size_t)(J - K) * NB * NB + 4 * mc;
    T acc[4][4] = {};
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      T a[4], bb[4];
      load4(PI + k * NB, a);
      load4(PJ + k * NB, bb);
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[v][u] += a[u] * bb[v];
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int u = 0; u < 4; ++u) old[v][u] -= acc[v][u];
      store4(out + (4 * mc + v) * NB + 4 * mr, old[v]);
    }
  }
}

// Copy count elements (a multiple of 4, 16-byte aligned) with all threads.
template <typename T>
__device__ void copy_block(T* dst, const T* src, int count) {
  for (int e = 4 * threadIdx.x; e < count; e += 4 * blockDim.x) {
    T q[4];
    load4(src + e, q);
    store4(dst + e, q);
  }
}

// Factor the tiles in place, right-looking by panels with a look-ahead of
// one: once panel K is solved, the diagonal tile (K+1, K+1) is updated
// first, and then warp 0 factors it while the other 15 warps update the
// rest of the trailing triangle. panel_buf: shared memory for two panels
// (2 nt tiles) when the tiles are streamed from global memory, else nullptr
// (resident tiles, or a panel too large for shared memory: in place).
template <typename T, int NB>
__device__ void factor(T* tiles, T* panel_buf, T* inv_d, int nt) {
  auto panel_of = [&](int K) -> T* {
    return panel_buf ? panel_buf + (size_t)(K & 1) * nt * NB * NB
                     : tiles + (size_t)tile_index(K, K, nt) * NB * NB;
  };
  if (panel_buf) {
    copy_block(panel_buf, tiles, nt * NB * NB);
    __syncthreads();
  }
  if (threadIdx.x < 32) factor_diagonal<T, NB>(panel_of(0), inv_d);
  __syncthreads();
  for (int K = 0; K < nt; ++K) {
    T* panel = panel_of(K);
    const int m = nt - 1 - K;
    solve_panel<T, NB>(panel, inv_d + K * NB, m);
    __syncthreads();
    if (panel_buf)
      copy_block(tiles + (size_t)tile_index(K, K, nt) * NB * NB, panel,
                 (m + 1) * NB * NB);
    if (m == 0) break;
    T* next = panel_of(K + 1);
    T* out_col = panel_buf ? next : nullptr;
    update_tiles<T, NB>(tiles, panel, out_col, K, nt, 0, 1, threadIdx.x,
                        blockDim.x);     // the next diagonal tile first
    __syncthreads();
    if (threadIdx.x < 32)
      factor_diagonal<T, NB>(next, inv_d + (K + 1) * NB);
    else
      update_tiles<T, NB>(tiles, panel, out_col, K, nt, 1, m * (m + 1) / 2,
                          threadIdx.x - 32, blockDim.x - 32);
    __syncthreads();
  }
  __syncthreads();
  for (int K = threadIdx.x >> 5; K < nt; K += blockDim.x >> 5)
    invert_diagonal<T, NB>(tiles + (size_t)tile_index(K, K, nt) * NB * NB,
                           inv_d + K * NB);
  __syncthreads();
}

// Forward (L y = v) and back (L^T x = y) substitution on the factored
// tiles, in place in v (shared memory, nt * NB); then x[i] = v[i], i < n.
// Per tile step, warp 0 applies the diagonal tile's inverse M (one row or
// column per lane, from M or its mirror), then all threads apply the
// tile's matrix-vector product to the rows below (forward: a row per
// thread) or the columns to the left (back: a column per thread, its reads
// skewed so that a warp's are conflict-free).
template <typename T, int NB>
__device__ void substitute(const T* tiles, T* v, T* __restrict__ x, int n,
                           int nt) {
  const int lane = threadIdx.x & 31;
  for (int I = 0; I < nt; ++I) {
    const T* D = tiles + (size_t)tile_index(I, I, nt) * NB * NB;
    T* w = v + I * NB;
    if (threadIdx.x < 32) {           // y_r = sum_{c <= r} M[r][c] w_c
      T s0 = T(0), s1 = T(0);
      if (lane < NB) {
#pragma unroll
        for (int c = 0; c < NB; c += 2) {
          if (c <= lane) s0 += D[c * NB + lane] * w[c];
          if (c + 1 <= lane) s1 += D[(c + 1) * NB + lane] * w[c + 1];
        }
      }
      __syncwarp();
      if (lane < NB) w[lane] = s0 + s1;
    }
    __syncthreads();
    const T* below = D + NB * NB;     // (I+1, I), (I+2, I), ... contiguous
    for (int q = threadIdx.x; q < (nt - 1 - I) * NB; q += blockDim.x) {
      const T* P = below + (size_t)(q / NB) * NB * NB + q % NB;
      T s0 = T(0), s1 = T(0);
#pragma unroll
      for (int c = 0; c < NB; c += 2) {
        s0 += P[c * NB] * w[c];
        s1 += P[(c + 1) * NB] * w[c + 1];
      }
      v[(I + 1) * NB + q] -= s0 + s1;
    }
    __syncthreads();
  }
  for (int I = nt - 1; I >= 0; --I) {
    const T* D = tiles + (size_t)tile_index(I, I, nt) * NB * NB;
    T* w = v + I * NB;
    if (threadIdx.x < 32) {           // x_c = sum_{r >= c} M[r][c] w_r
      T s0 = T(0), s1 = T(0);
      if (lane < NB) {
#pragma unroll
        for (int r = 0; r < NB; r += 2) {
          if (r >= lane) s0 += D[r * NB + lane] * w[r];
          if (r + 1 >= lane) s1 += D[(r + 1) * NB + lane] * w[r + 1];
        }
      }
      __syncwarp();
      if (lane < NB) w[lane] = s0 + s1;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < I * NB; q += blockDim.x) {
      const int J = q / NB, c = q % NB;   // v_J -= L_IJ^T x_I
      const T* P = tiles + (size_t)tile_index(I, J, nt) * NB * NB + c * NB;
      T s0 = T(0), s1 = T(0);
#pragma unroll
      for (int s = 0; s < NB; s += 2) {
        const int r0 = (s + c) % NB, r1 = (s + 1 + c) % NB;  // skewed
        s0 += P[r0] * w[r0];
        s1 += P[r1] * w[r1];
      }
      v[q] -= s0 + s1;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = v[i];
}

// One block per system. Shared memory: [tiles (resident) | two panels
// (streamed, when they fit)] then v and inv_d (nt * NB each). W is the
// streamed tiles' workspace, nt(nt+1)/2 * NB * NB elements per system
// (unused if resident).
template <typename T, int NB, typename Prologue>
__global__ void __launch_bounds__(kThreads, 1)
solve_kernel(const T* __restrict__ A, const T* __restrict__ b, Prologue pro,
             T* __restrict__ x, T* __restrict__ W, int n, int resident,
             int panel_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nt = (n + NB - 1) / NB;
  const size_t tri = (size_t)nt * (nt + 1) / 2 * NB * NB;
  const size_t sys = blockIdx.x;
  T* tiles;
  T* panel_buf = nullptr;
  T* v;
  if (resident) {
    tiles = smem;
    v = smem + tri;
  } else {
    tiles = W + sys * tri;
    if (panel_in_smem) panel_buf = smem;
    v = smem + (panel_in_smem ? (size_t)2 * nt * NB * NB : 0);
  }
  T* inv_d = v + nt * NB;
  load_system<T, NB>(tiles, v, A + sys * n * n, b + sys * n, pro.at(sys), n,
                     nt);
  __syncthreads();
  factor<T, NB>(tiles, panel_buf, inv_d, nt);
  substitute<T, NB>(tiles, v, x + sys * n, n, nt);
}

// Launch on `stream` of `device` without synchronising; the plan's numbers
// (nb, resident, panel_in_smem, smem bytes) come from the caller. The
// shared-memory attribute is set once per instantiation, device and larger
// size. Returns the CUDA error code of the launch (0 when accepted).
template <typename T, int NB, typename Prologue>
int launch(const T* A, const T* b, Prologue pro, T* x, T* W, int batch, int n,
           int nb, int resident, int panel_in_smem, int smem, int device,
           void* stream) {
  if (batch <= 0 || n <= 0 || nb != NB || smem <= 0)
    return (int)cudaErrorInvalidValue;
  if (!resident && W == nullptr) return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  static int smem_set[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices || smem > smem_set[device]) {
    err = cudaFuncSetAttribute(solve_kernel<T, NB, Prologue>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < kMaxDevices) smem_set[device] = smem;
  }
  solve_kernel<T, NB, Prologue><<<batch, kThreads, smem,
                                  (cudaStream_t)stream>>>(
      A, b, pro, x, W, n, resident, panel_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace blocked_cholesky
