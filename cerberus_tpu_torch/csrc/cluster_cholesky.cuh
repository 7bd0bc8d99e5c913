// Blocked Cholesky factor and both substitutions of one SPD system per
// thread-block cluster of C blocks (512 threads each), for sm_90a: the f64
// body of lane_cholesky.cu for a few systems too large for one block's
// shared memory (ops/lane_cholesky.py::solve_plan routes them here).
//
// Replaces, with lane_cholesky.cu, the TPU kernel
// cerberus_tpu/ops/lane_cholesky.py::lane_cholesky_solve (body `_kernel`)
// at the solver's full (222 + F)-dim system: f64, B = 1, n = 382.
//
// Storage. The tile layout of blocked_cholesky.cuh (NB x NB tiles of the
// lower triangle, column-major inside a tile; a factored diagonal tile
// holds its inverse M and M's mirror), spread over the cluster's ranks:
// block-column J belongs to rank J % C, which keeps it resident in its
// shared memory, its columns one after another, each from its diagonal
// tile down. No workspace holds the triangle. Every rank's shared memory
// has the same layout (cluster.map_shared_rank finds the same offset):
//   [ tiles of its block-columns (room for rank 0's, the most)
//   | panel buffer: the nt - 1 tiles below a diagonal tile, then y_K
//   | one tile: (K+1, K), for the next diagonal tile
//   | v (nt NB): the right-hand side of its columns, then y, then x
//   | inv_d (nt NB): 1 / L[r][r] of its diagonal tiles ].
// Panels pass between ranks through W, two staged panels per system
// (panel K in slot K % 2): each rank reads a panel from L2 at its own rate,
// where pulling it from the owner's shared memory made the owner's SM
// serve every other rank (csrc/DESIGN.md).
//
// Factor, right-looking by panels. Step K has two phases of the cluster
// barrier: 2K, tile (K+1, K) staged; 2K+1, the rest of panel K and y_K
// staged. The owner of block-column K solves the panel below its factored
// diagonal tile (TRSM, a row per thread) and, as one more row, the
// right-hand side segment: y_K = L_KK^-1 w_K, so the forward substitution
// is folded into the factor (w is an extra block row of A). Each rank
// updates its own trailing tiles (A_IJ -= L_IK L_JK^T, a 4 x 4 micro-tile
// per thread, as blocked_cholesky.cuh's update) and right-hand side rows
// (w_J -= L_JK y_K) from its copy of the panel. Look-ahead: on the owner of
// K+1, warp 0 updates the diagonal tile (K+1, K+1) as soon as tile
// (K+1, K) is staged, factors it while the other warps update, and, once
// they have updated tile (K+2, K+1) (named barrier 2), solves that first
// tile of panel K+1 and arrives on phase 2K+2 at once. A warp arrives on a
// phase as soon as it has nothing more to give it, and all its lanes
// together: arrivals split across a warp hung the card. No rank writes
// another's tiles.
//
// Back substitution (L^T x = y), block row by block row from the last: the
// owner of I applies M_II^T to its v_I (y_I less what the x_J, J > I,
// took), writes x_I into v_I of every rank, and all ranks pass one cluster
// barrier; each rank then subtracts L_IJ^T x_I from its own v_J, J < I.
// Every sum runs in a fixed order and no floating-point atomics are used,
// so a given input gives the same bits on every launch. The kernel ends
// with a cluster barrier: no block exits while another may still touch its
// shared memory.
//
// Bound on an H100 SXM (700 W), n = 382, f64: 8 (n(n+1)/2 + 2n) = 0.59 MB
// over 3.35 TB/s, 0.18 us, against n^3/3 + 2n^2 = 18.9 MFLOP: 0.28 us at
// the card's 67 TFLOP/s f64 tensor-core peak that chip_smoke.py's bound
// uses, 0.56 us at 34 TFLOP/s outside the tensor cores, where this update
// runs. The cluster occupies C SMs of 132, whose own FMA rate (C/132 of
// 34 TFLOP/s) allows 18.9 MFLOP / (C x 0.258 TFLOP/s): 18 us at C = 4,
// 9.2 us at C = 8, 4.6 us at C = 16.
//
// What the design does about the two limits of the one-block body at this
// shape (blocked_cholesky.cuh, streamed): the triangle (614,400 B at
// NB = 16) no longer crosses L2 once per panel step, since the ranks'
// pooled shared memory holds it resident; and the trailing update runs on
// C SMs' FMA pipes instead of one. What is left is the chain of each step,
// on one SM at a time: the TRSM, two crossings between SMs, the diagonal
// tile's factor (NB dependent steps of shuffle, reciprocal square root and
// FMA on one warp); and the back substitution's nt cluster barriers.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "blocked_cholesky.cuh"

namespace cluster_cholesky {

namespace cg = cooperative_groups;
using blocked_cholesky::factor_diagonal;
using blocked_cholesky::invert_diagonal;
using blocked_cholesky::kMaxDevices;
using blocked_cholesky::kThreads;
using blocked_cholesky::load4;
using blocked_cholesky::store4;

// Phase readings for tools/cholesky_phases.py, which defines them in its
// copy of this file; nothing here.
#ifndef CLUSTER_PHASE
#define CLUSTER_PHASE_START
#define CLUSTER_PHASE(k)
#endif

constexpr int kMaxCluster = 16;   // with the non-portable attribute
constexpr int kCopyBatch = 4;     // 16-byte loads a thread has in flight

// Split cluster barrier: every thread of every block arrives once per
// phase, then waits; the arrival releases the thread's writes, the wait
// acquires everyone's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Block-columns of rank r: r, r + C, ...; how many of nt.
__host__ __device__ __forceinline__ int rank_columns(int r, int nt, int C) {
  return r < nt ? (nt - r + C - 1) / C : 0;
}

// Tiles before rank r's j-th block-column (J = r + C j) in its storage.
__host__ __device__ __forceinline__ int column_offset(int r, int j, int nt,
                                                      int C) {
  return j * (nt - r) - C * j * (j - 1) / 2;
}

// Tiles rank r keeps: sum over its block-columns J of nt - J.
__host__ __device__ __forceinline__ int rank_tiles(int r, int nt, int C) {
  return column_offset(r, rank_columns(r, nt, C), nt, C);
}

// Fill rank r's tiles with its block-columns of the row-major n x n system
// A (its lower triangle; the padding is the identity, the strictly upper
// half of a diagonal tile 0) and v's segments of its columns with b (the
// others 0). One warp per tile, as blocked_cholesky::load_system.
template <typename T, int NB>
__device__ void load_columns(T* tiles, T* v, const T* __restrict__ A,
                             const T* __restrict__ b, int n, int nt, int r,
                             int C) {
  constexpr int kPerLane = NB * NB / 32;
  constexpr int kBatch = kPerLane < blocked_cholesky::kLoadBatch
                             ? kPerLane : blocked_cholesky::kLoadBatch;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int total = rank_tiles(r, nt, C);
  for (int t = threadIdx.x >> 5; t < total; t += nwarps) {
    int j = 0, i = t, J = r;
    while (i >= nt - J) { i -= nt - J; ++j; J += C; }
    const int I = J + i;
    T* tile = tiles + (size_t)t * NB * NB;
#pragma unroll
    for (int g0 = 0; g0 < kPerLane; g0 += kBatch) {
      T val[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + u;
        const int rr = lane % 8 + 8 * (g % (NB / 8));
        const int c = lane / 8 + 4 * (g / (NB / 8));
        const int R = I * NB + rr, Cc = J * NB + c;
        if (R < n && Cc < n)
          val[u] = Cc <= R ? A[(size_t)R * n + Cc] : T(0);
        else
          val[u] = R == Cc ? T(1) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + u;
        const int rr = lane % 8 + 8 * (g % (NB / 8));
        const int c = lane / 8 + 4 * (g / (NB / 8));
        tile[c * NB + rr] = val[u];
      }
    }
  }
  for (int i = threadIdx.x; i < nt * NB; i += blockDim.x)
    v[i] = (i < n && (i / NB) % C == r) ? b[i] : T(0);
}

// 16-byte loads that bypass L1, for the staged panels (written by another
// SM since this one may have cached the address).
__device__ __forceinline__ void load4_cg(const double* p, double (&v)[4]) {
  const double2 q0 = __ldcg(reinterpret_cast<const double2*>(p));
  const double2 q1 = __ldcg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

// Threads tid of nthreads: copy count elements (a multiple of 4, 16-byte
// aligned) of a staged panel into shared memory, kCopyBatch 16-byte loads
// in flight per thread.
template <typename T>
__device__ void copy_staged(T* dst, const T* src, int count, int tid,
                            int nthreads) {
  const int step = 4 * nthreads;
  for (int e0 = 4 * tid; e0 < count; e0 += kCopyBatch * step) {
    T q[kCopyBatch][4];
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u)
      if (e0 + u * step < count) load4_cg(src + e0 + u * step, q[u]);
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u)
      if (e0 + u * step < count) store4(dst + e0 + u * step, q[u]);
  }
}

// Rows q0 + tid, q0 + tid + nthreads, ... of the panel below the factored
// diagonal tile D: rows q < m NB of its m tiles (L_IK = A_IK L_KK^-T, a row
// per thread) and, as row m NB, the right-hand side segment w (y_K^T =
// w^T L_KK^-T, i.e. y_K = L_KK^-1 w), each row written in place and to the
// staged panel S (tiles below the diagonal, then y_K).
template <typename T, int NB>
__device__ void solve_panel_rows(T* D, const T* inv_d, int m, T* w, T* S,
                                 int nt, int q0, int q_end, int tid,
                                 int nthreads) {
  for (int q = q0 + tid; q < q_end; q += nthreads) {
    T* P;
    T* Sq;
    int stride;
    if (q < m * NB) {
      P = D + (size_t)(1 + q / NB) * NB * NB + q % NB;
      Sq = S + (size_t)(q / NB) * NB * NB + q % NB;
      stride = NB;
    } else {
      P = w;
      Sq = S + (size_t)(nt - 1) * NB * NB;
      stride = 1;
    }
    T a[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) a[c] = P[c * stride];
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
    for (int c = 0; c < NB; ++c) {
      P[c * stride] = a[c];
      Sq[c * stride] = a[c];
    }
  }
}

// Warp 0 of the owner of block-column K, once its diagonal tile is
// factored and tile (K+1, K) updated: that tile's rows (lanes < NB), staged
// and fenced; then the warp arrives on phase 2K of the cluster barrier,
// which is all that the next column's owner waits for first.
template <typename T, int NB>
__device__ void solve_first_tile(T* D, const T* inv_d, int m, T* S, int nt) {
  const int lane = threadIdx.x & 31;
  solve_panel_rows<T, NB>(D, inv_d, m, nullptr, S, nt, 0, NB, lane, 32);
  __threadfence();
  __syncwarp();
  cluster_arrive();
}

// C_tile -= PI PJ^T on the 4 x 4 micro-tile (mr, mc) of an NB x NB tile;
// PI, PJ: the two panel tiles (column-major).
template <typename T, int NB>
__device__ __forceinline__ void micro_update(T* Ct, const T* PI,
                                             const T* PJ, int mr, int mc) {
  T old[4][4];
#pragma unroll
  for (int vv = 0; vv < 4; ++vv)
    load4(Ct + (4 * mc + vv) * NB + 4 * mr, old[vv]);
  T acc[4][4] = {};
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    T a[4], bb[4];
    load4(PI + k * NB + 4 * mr, a);
    load4(PJ + k * NB + 4 * mc, bb);
#pragma unroll
    for (int vv = 0; vv < 4; ++vv)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[vv][u] += a[u] * bb[vv];
  }
#pragma unroll
  for (int vv = 0; vv < 4; ++vv) {
#pragma unroll
    for (int u = 0; u < 4; ++u) old[vv][u] -= acc[vv][u];
    store4(Ct + (4 * mc + vv) * NB + 4 * mr, old[vv]);
  }
}

// Item it of rank r's update by panel K (below): its block-columns from
// j_begin (J = r + C j > K) in turn, each with its tiles (I, J), I >= J (from
// I = J + 1 in the first column if skip_diag), a 4 x 4 micro-tile an item
// (A_IJ -= L_IK L_JK^T), then its right-hand side rows, 4 an item
// (w_J -= L_JK y_K). below[(I - K - 1) NB^2] is L_IK; yK is y_K.
template <typename T, int NB>
__device__ void update_item(T* tiles, T* v, const T* below, const T* yK,
                            int K, int nt, int r, int C, int j_begin,
                            int skip_diag, int it) {
  constexpr int MT = NB / 4;
  constexpr int TS = NB * NB;
  int j = j_begin, J = r + C * j_begin, rem = it, i0 = skip_diag;
  while (rem >= (nt - J - i0) * MT * MT + MT) {
    rem -= (nt - J - i0) * MT * MT + MT;
    ++j;
    J += C;
    i0 = 0;
  }
  const T* PJ = below + (size_t)(J - K - 1) * TS;      // L_JK
  if (rem < (nt - J - i0) * MT * MT) {
    const int i = i0 + rem / (MT * MT), mt = rem % (MT * MT);
    const int mr = mt % MT, mc = mt / MT;
    if (i == 0 && mc > mr) return;    // wholly above the diagonal
    micro_update<T, NB>(
        tiles + (size_t)(column_offset(r, j, nt, C) + i) * TS,
        below + (size_t)(J + i - K - 1) * TS, PJ, mr, mc);
  } else {
    const int q = rem - (nt - J - i0) * MT * MT;  // rows 4q .. 4q+3 of w_J
    T acc[4] = {};
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      T l[4];
      load4(PJ + k * NB + 4 * q, l);
      const T y = yK[k];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += l[u] * y;
    }
    T* w = v + J * NB + 4 * q;
    T old[4];
    load4(w, old);
#pragma unroll
    for (int u = 0; u < 4; ++u) old[u] -= acc[u];
    store4(w, old);
  }
}

// Warps from 1 whose threads (tid = threadIdx.x - 32) update the first
// tile below the next diagonal tile, and signal warp 0 on named barrier 2.
template <int NB>
__host__ __device__ constexpr int signal_threads() {
  return 32 * ((NB * NB / 16 + 31) / 32);
}

// The whole update by panel K, threads tid of nthreads, for the columns
// before j_end. If signal, the threads of the first tile below the next
// diagonal tile (tid < signal_threads) arrive on named barrier 2 once that
// tile is done, for warp 0's solve_first_tile.
template <typename T, int NB>
__device__ void update_columns(T* tiles, T* v, const T* below, const T* yK,
                               int K, int nt, int r, int C, int j_begin,
                               int j_end, int skip_diag, int signal, int tid,
                               int nthreads) {
  constexpr int MT = NB / 4;        // micro-tiles along a tile's edge
  constexpr int kSignal = signal_threads<NB>();
  int total = 0;
  for (int j = j_begin; j < j_end; ++j)
    total += (nt - (r + C * j) - (j == j_begin ? skip_diag : 0)) * MT * MT
             + MT;
  if (tid < total)
    update_item<T, NB>(tiles, v, below, yK, K, nt, r, C, j_begin, skip_diag,
                       tid);
  if (signal && tid < kSignal) {
    __syncwarp();
    asm volatile("bar.arrive 2, %0;\n" :: "r"(32 + kSignal) : "memory");
  }
  for (int it = tid + nthreads; it < total; it += nthreads)
    update_item<T, NB>(tiles, v, below, yK, K, nt, r, C, j_begin, skip_diag,
                       it);
}

// Barrier of the threads from warp 1 on (named barrier 1).
__device__ __forceinline__ void sync_update_warps() {
  asm volatile("bar.sync 1, %0;\n" :: "r"(blockDim.x - 32) : "memory");
}

// One cluster of C blocks per system (grid: B C blocks, cluster C x 1 x 1).
// W: the staged panels, two per system (panel K in slot K % 2).
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads, 1)
cluster_solve_kernel(const T* __restrict__ A, const T* __restrict__ b,
                     T* __restrict__ x, T* __restrict__ W, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TS = NB * NB;
  constexpr int MT = NB / 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const size_t sys = blockIdx.x / C;
  const int nt = (n + NB - 1) / NB;
  const size_t slot = (size_t)(nt - 1) * TS + NB;
  T* tiles = reinterpret_cast<T*>(smem_raw);
  T* pbuf = tiles + (size_t)rank_tiles(0, nt, C) * TS;
  T* yK_buf = pbuf + (size_t)(nt - 1) * TS;
  T* dtile = yK_buf + NB;           // tile (K+1, K), for the look-ahead
  T* v = dtile + TS;
  T* inv_d = v + nt * NB;
  const int ncols = rank_columns(r, nt, C);
  T* stage = W + sys * 2 * slot;

  CLUSTER_PHASE_START
  load_columns<T, NB>(tiles, v, A + sys * n * n, b + sys * n, n, nt, r, C);
  __syncthreads();
  if (r == 0 && threadIdx.x < 32) {
    factor_diagonal<T, NB>(tiles, inv_d);
    __syncwarp();
    solve_first_tile<T, NB>(tiles, inv_d, nt - 1, stage, nt);
  }
  __syncthreads();
  CLUSTER_PHASE(0)

  // Two cluster barrier phases per step K: 2K, tile (K+1, K) staged (by
  // warp 0 of the owner of K, in the step before); 2K+1, the whole panel
  // and y_K staged. A thread arrives on a phase as soon as it has nothing
  // more to give to it, and waits when it needs what the phase brings.
  for (int K = 0; K < nt; ++K) {
    const int owner = K % C, next = (K + 1) % C, m = nt - 1 - K;
    T* S = stage + (size_t)(K & 1) * slot;
    T* colK = tiles + (size_t)column_offset(r, K / C, nt, C) * TS;
    if (!(owner == r && m > 0 && threadIdx.x < 32)) cluster_arrive();
    if (owner == r) {               // the rest of the panel, and y_K
      const int q0 = m > 0 ? NB : 0;
      solve_panel_rows<T, NB>(colK, inv_d + K * NB, m, v + K * NB, S, nt,
                              q0, m * NB + 1, threadIdx.x, blockDim.x);
      __threadfence();
      CLUSTER_PHASE(1)
    }
    cluster_wait();                 // phase 2K
    cluster_arrive();               // phase 2K+1
    if (m == 0) {
      cluster_wait();
      break;
    }
    // this rank's first block-column right of K
    const int j0 = K >= r ? (K - r) / C + 1 : 0;
    T* D1 = tiles + (size_t)column_offset(r, j0, nt, C) * TS;
    const int early = next == r && m > 1;   // column K+1 has a tile below
    if (next == r && threadIdx.x < 32) {
      // warp 0 of the next column's owner: (K+1, K+1) -= L L^T with
      // L = L_{K+1,K}, then its factor, while the other warps update; then
      // the first tile of panel K+1, once they have updated it
      copy_staged(dtile, S, TS, threadIdx.x, 32);
      __syncwarp();
      for (int t = threadIdx.x; t < MT * MT; t += 32) {
        const int mr = t % MT, mc = t / MT;
        if (mc <= mr) micro_update<T, NB>(D1, dtile, dtile, mr, mc);
      }
      __syncwarp();
      CLUSTER_PHASE(4)
      factor_diagonal<T, NB>(D1, inv_d + (K + 1) * NB);
      CLUSTER_PHASE(5)
      cluster_wait();               // phase 2K+1
      if (early) {
        asm volatile("bar.sync 2, %0;\n" :: "r"(32 + signal_threads<NB>())
                     : "memory");
        __syncwarp();
        solve_first_tile<T, NB>(D1, inv_d + (K + 1) * NB, m - 1,
                                stage + (size_t)((K + 1) & 1) * slot, nt);
      }
    } else {
      cluster_wait();               // phase 2K+1: panel K and y_K staged
      CLUSTER_PHASE(2)
      const int tid = next == r ? threadIdx.x - 32 : threadIdx.x;
      const int nthreads = next == r ? blockDim.x - 32 : blockDim.x;
      const T* below;
      const T* yK;
      if (owner == r) {
        below = colK + TS;
        yK = v + K * NB;
      } else {
        copy_staged(pbuf, S, m * TS, tid, nthreads);
        copy_staged(yK_buf, S + (size_t)(nt - 1) * TS, NB, tid, nthreads);
        if (next == r)
          sync_update_warps();
        else
          __syncthreads();
        CLUSTER_PHASE(3)
        below = pbuf;
        yK = yK_buf;
      }
      update_columns<T, NB>(tiles, v, below, yK, K, nt, r, C, j0, ncols,
                            next == r, early, tid, nthreads);
    }
    __syncthreads();
    CLUSTER_PHASE(next == r ? 6 : 7)
  }

  // M = L^-1 of each of this rank's diagonal tiles, a warp each
  for (int j = threadIdx.x >> 5; j < ncols; j += blockDim.x >> 5)
    invert_diagonal<T, NB>(tiles + (size_t)column_offset(r, j, nt, C) * TS,
                           inv_d + (r + C * j) * NB);
  __syncthreads();
  CLUSTER_PHASE(8)

  const int lane = threadIdx.x & 31;
  for (int I = nt - 1; I >= 0; --I) {
    if (I % C == r && threadIdx.x < 32) {   // x_c = sum_{r' >= c} M[r'][c] w_r'
      const T* D = tiles + (size_t)column_offset(r, I / C, nt, C) * TS;
      T* w = v + I * NB;
      T s0 = T(0), s1 = T(0);
      if (lane < NB) {
#pragma unroll
        for (int rr = 0; rr < NB; rr += 2) {
          if (rr >= lane) s0 += D[rr * NB + lane] * w[rr];
          if (rr + 1 >= lane) s1 += D[(rr + 1) * NB + lane] * w[rr + 1];
        }
      }
      __syncwarp();
      if (lane < NB) {
        const T xv = s0 + s1;
        w[lane] = xv;
        for (int q = 0; q < C; ++q)
          if (q != r) *cluster.map_shared_rank(w + lane, q) = xv;
      }
    }
    CLUSTER_PHASE(9)
    cluster_arrive();
    cluster_wait();                 // x_I in every rank's v_I
    CLUSTER_PHASE(10)
    if (I == 0) break;
    // v_J -= L_IJ^T x_I for this rank's block-columns J < I: a column of
    // tile (I, J) per thread, its reads skewed
    const int jn = I > r ? (I - r + C - 1) / C : 0;
    const T* xI = v + I * NB;
    for (int q = threadIdx.x; q < jn * NB; q += blockDim.x) {
      const int j = q / NB, c = q % NB, J = r + C * j;
      const T* P = tiles + (size_t)(column_offset(r, j, nt, C) + I - J) * TS
                   + c * NB;
      T s0 = T(0), s1 = T(0);
#pragma unroll
      for (int s = 0; s < NB; s += 2) {
        const int r0 = (s + c) % NB, r1 = (s + 1 + c) % NB;
        s0 += P[r0] * xI[r0];
        s1 += P[r1] * xI[r1];
      }
      v[J * NB + c] -= s0 + s1;
    }
    __syncthreads();
    CLUSTER_PHASE(11)
  }
  for (int j = 0; j < ncols; ++j)
    for (int i = threadIdx.x; i < NB; i += blockDim.x) {
      const int e = (r + C * j) * NB + i;
      if (e < n) x[sys * n + e] = v[e];
    }
  cluster_arrive();                 // no block leaves while another may
  cluster_wait();                   // still touch its shared memory
  CLUSTER_PHASE(12)
}

// Launch B clusters of C blocks on `stream` of `device` without
// synchronising; nb, C and the shared memory per block come from the plan
// (ops/lane_cholesky.py::solve_plan). Before the first launch of an
// instantiation at a (device, C, larger shared memory), asks CUDA how many
// such clusters the card can place at once and returns an error if none
// (nothing falls back). Returns the CUDA error code (0 when accepted).
template <typename T, int NB>
int launch(const T* A, const T* b, T* x, T* W, int batch, int n, int nb,
           int C, int smem, int device, void* stream) {
  if (batch <= 0 || n <= NB || nb != NB || C < 2 || smem <= 0 || !W)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  auto kernel = cluster_solve_kernel<T, NB>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool cached = device >= 0 && device < kMaxDevices && C <= kMaxCluster;
  static int smem_set[kMaxDevices] = {};                  // the attribute
  static int placed[kMaxDevices][kMaxCluster + 1] = {};   // smem checked
  if (!cached || smem > smem_set[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (cached) smem_set[device] = smem;
  }
  if (!cached || smem > placed[device][C]) {
    if (C > 8) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters == 0) return (int)cudaErrorInvalidConfiguration;
    if (cached) placed[device][C] = smem;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, A, b, x, W, n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace cluster_cholesky
