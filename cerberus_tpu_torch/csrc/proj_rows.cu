// Projection residuals and their local Jacobians of every (window, feature
// slot, frame) pair of a batch, f32 and f64, for sm_90a.
//
// Replaces no TPU kernel. The JAX package takes these rows with a vmapped
// jax.jacrev (cerberus_tpu/ops/structured.py); the port did the same with
// torch.func.jacrev (ops/proj_rows.py::proj_rows_plain, which stays as the
// plain version), and on the card that backward pass under vmap ran as
// ~1,300 elementwise kernels an assembly at about 0.5 % of the card's
// bandwidth. This kernel computes the same (r, J) from the derivatives
// written out, in one launch an assembly for the whole batch.
//
// What it computes, per pair (b, f, j) with anchor frame s = start[b, f]:
// the 4 residuals [mono x, y | stereo x, y] of res26 in
// ops/proj_rows.py::proj_rows_plain and their derivatives with respect to
// the 26-dim local tangent [pose_s(6) pose_j(6) ex0(6) ex1(6) depth td],
// under the port's perturbations: p + dp, normalize(q (x) delta_q(dtheta))
// with delta_q(t) = normalize([1, t/2]) -- at a state q that is not exactly
// unit, normalize(q (x) dq) = (q/|q|) (x) (dq/|dq|), so the rotation is that
// of q/|q| and its derivative R(q/|q|) [dtheta]x --; inverse depth + d;
// td + d, through the anchor's and frame j's velocities. A camera depth
// |z| < 1e-6 is clamped to 1e-6 with a zero derivative, as torch.where
// gives it. Rows of a camera whose mask is false (mono: obs_j, obs_s,
// j != s, valid; stereo: stereo_j, obs_s, valid) are zero, and so are
// both cameras' rows of an anchor frame outside the window.
// r is (B, F, 11, 4) and J (B, F, 11, 4, 26), contiguous; the kernel
// writes every element of both.
//
// Bound: bytes. Every pair writes 4 + 104 values; a pair with a camera's
// mask on also reads 11 values and two mask bytes (a pair with both masks
// off reads none of its values). With every mask on that is
// 119 x 4 + 2 = 478 B in f32, 954 B in f64; at F = 160 7,208,960 pairs in
// f32 (B = 4,096) and 3,604,480 in f64 (B = 2,048) are 3.45 and 3.44 GB,
// 1.03 ms at 3.35 TB/s; the writes alone, 3.11 GB, take 0.93 ms. The
// arithmetic, a few hundred operations a pair, takes well under 0.1 ms at
// either type's rate. Given a counter, the kernel adds the number of pairs
// that read their values to it (one atomic add a block), so that a reader
// can count the bytes it moved.
//
// Design: one block of 4 warps per (window, 128 consecutive pairs of it).
// The window's 11 poses, both extrinsics (as rotation matrices of the
// normalized quaternions) and td are built once in shared memory. One
// thread computes one pair in registers and writes its 104 Jacobian
// entries to its own row of a per-warp staging buffer; the warp's pairs
// are consecutive in J, so the warp then writes its rows out as 16-byte
// vectors, consecutive lanes on consecutive addresses (a per-thread store
// at a 104-element stride would use a fraction of each sector it touches).
// r (4 values a pair, consecutive too) goes out from registers as vectors.
// The stores stream (st.global.cs): nothing reads the rows again before
// the next stage's kernels, and 3.4 GB do not fit the 50 MB L2.
// Arithmetic in the working type; no fast-math intrinsics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace proj_rows {

constexpr int NF = 11;        // keyframes of a window
constexpr int NT = 26;        // local tangent of a pair
constexpr int NJ = 4 * NT;    // Jacobian entries of a pair
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDevices = 64;

// A pair's row in the staging buffer, in elements: 16-byte aligned, with
// as few lanes of a warp on one bank as that allows when each lane writes
// its own pair (f32: 108, 4 lanes a bank; f64: 106, 2 of a half-warp's 16).
template <typename T> struct Stage;
template <> struct Stage<float> {
  static constexpr int kStride = 108;
  using V = float4;
};
template <> struct Stage<double> {
  static constexpr int kStride = 106;
  using V = double2;
};

// The window in shared memory: the frames' rotations and positions, then
// ex0's and ex1's; rotations row-major.
template <typename T>
struct Window {
  T R[NF + 2][9];
  T p[NF + 2][3];
  T td;
  int reads;    // pairs of the block that read their values
};

template <typename T>
struct Inputs {
  const T *p, *q, *tic, *qic, *td, *depth;
  const int32_t* start;
  const T *pts, *pts_r, *vel, *vel_r, *ftd;
  const uint8_t *obs, *stereo, *valid;
};

// ---- the arithmetic of one pair ----

template <typename T>
__device__ __forceinline__ void rotation(const T* q, T* R) {
  const T n = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const T w = q[0] / n, x = q[1] / n, y = q[2] / n, z = q[3] / n;
  R[0] = 1 - 2 * (y * y + z * z);
  R[1] = 2 * (x * y - w * z);
  R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z);
  R[4] = 1 - 2 * (x * x + z * z);
  R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y);
  R[7] = 2 * (y * z + w * x);
  R[8] = 1 - 2 * (x * x + y * y);
}

template <typename T>
__device__ __forceinline__ void mul(const T* M, const T* v, T* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = M[3 * i] * v[0] + M[3 * i + 1] * v[1] + M[3 * i + 2] * v[2];
}

template <typename T>
__device__ __forceinline__ void mul_t(const T* M, const T* v, T* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = M[i] * v[0] + M[3 + i] * v[1] + M[6 + i] * v[2];
}

template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// What one camera's two rows need besides the camera: the anchor point in
// the anchor camera (ci = a / lam), in the anchor body (u), in frame j's
// body (m); the poses involved; the anchor's velocity and inverse depth.
template <typename T>
struct Point {
  const T *Ri, *Rj, *Rc0;
  T ci[3], u[3], m[3], vel_i[2], lam;
};

// The two rows of one camera: the left one (ex0, kStereo false) or the
// right one (ex1). obs: frame j's observation in this camera shifted by
// td, vel: its velocity. With D = dr/dpc, each row's columns follow from
// G = D Rc^T, H = G Rj^T, K = H Ri and KR = K Rc0 (as row vectors).
template <typename T, bool kStereo>
__device__ __forceinline__ void camera_rows(const Point<T>& P, const T* Rc,
                                            const T* tc, const T* obs,
                                            const T* vel, T sinfo, bool ok,
                                            T* r, T* J) {
  if (!ok) {
    for (int k = 0; k < 2; ++k) {
      r[k] = 0;
      for (int c = 0; c < NT; ++c) J[k * NT + c] = 0;
    }
    return;
  }
  const T e[3] = {P.m[0] - tc[0], P.m[1] - tc[1], P.m[2] - tc[2]};
  T pc[3];
  mul_t(Rc, e, pc);
  const bool clamped = fabs(pc[2]) < T(1e-6);
  const T z = clamped ? T(1e-6) : pc[2];
  for (int k = 0; k < 2; ++k) {
    r[k] = sinfo * (pc[k] / z - obs[k]);
    T D[3] = {0, 0, clamped ? T(0) : -sinfo * pc[k] / (z * z)};
    D[k] = sinfo / z;
    T G[3], H[3], K[3], KR[3], a[3], b[3];
    mul(Rc, D, G);
    mul(P.Rj, G, H);
    mul_t(P.Ri, H, K);
    mul_t(P.Rc0, K, KR);
    T* row = J + k * NT;
    cross(P.u, K, a);       // d/d theta_s = -K [u]x
    cross(G, P.m, b);       // d/d theta_j = G [m]x
    for (int c = 0; c < 3; ++c) {
      row[c] = H[c];
      row[3 + c] = a[c];
      row[6 + c] = -H[c];
      row[9 + c] = b[c];
    }
    cross(P.ci, KR, a);     // d/d theta_ex0 through the anchor: -KR [ci]x
    cross(D, pc, b);        // d/d theta of this camera's own ex: D [pc]x
    for (int c = 0; c < 3; ++c) {
      if (!kStereo) {
        row[12 + c] = K[c] - G[c];
        row[15 + c] = a[c] + b[c];
        row[18 + c] = 0;
        row[21 + c] = 0;
      } else {
        row[12 + c] = K[c];
        row[15 + c] = a[c];
        row[18 + c] = -G[c];
        row[21 + c] = b[c];
      }
    }
    row[24] = -(KR[0] * P.ci[0] + KR[1] * P.ci[1] + KR[2] * P.ci[2]) / P.lam;
    row[25] = -(KR[0] * P.vel_i[0] + KR[1] * P.vel_i[1]) / P.lam
              + sinfo * vel[k];
  }
}

// ---- the kernel ----

// Loads pair (b, f, j) and writes its 4 residuals to r and its 4 x 26
// Jacobian to J (row-major); false where both masks are off and the pair
// read none of its values.
template <typename T>
__device__ __forceinline__ bool pair_rows(const Inputs<T>& in,
                                          const Window<T>& W, int b, int F,
                                          int f, int j, T sinfo, T* r,
                                          T* J) {
  const size_t slot = (size_t)b * F + f;
  const int s = __ldg(in.start + slot);
  const bool inside = s >= 0 && s < NF;
  const size_t is = slot * NF + (inside ? s : 0);
  const size_t ij = slot * NF + j;
  const bool obs_i = inside && __ldg(in.valid + slot) && __ldg(in.obs + is);
  const bool mono_ok = obs_i && __ldg(in.obs + ij) && j != s;
  const bool st_ok = obs_i && __ldg(in.stereo + ij);
  if (!mono_ok && !st_ok) {
    for (int k = 0; k < 4; ++k) r[k] = 0;
    for (int c = 0; c < NJ; ++c) J[c] = 0;
    return false;
  }
  Point<T> P;
  P.Ri = W.R[s];
  P.Rj = W.R[j];
  P.Rc0 = W.R[NF];
  P.lam = __ldg(in.depth + slot);
  P.vel_i[0] = __ldg(in.vel + 2 * is);
  P.vel_i[1] = __ldg(in.vel + 2 * is + 1);
  const T dti = W.td - __ldg(in.ftd + is);
  const T a[3] = {__ldg(in.pts + 3 * is) - dti * P.vel_i[0],
                  __ldg(in.pts + 3 * is + 1) - dti * P.vel_i[1],
                  __ldg(in.pts + 3 * is + 2)};
  for (int c = 0; c < 3; ++c) P.ci[c] = a[c] / P.lam;
  T w[3];
  mul(P.Rc0, P.ci, w);
  for (int c = 0; c < 3; ++c) P.u[c] = w[c] + W.p[NF][c];
  mul(P.Ri, P.u, w);
  for (int c = 0; c < 3; ++c) w[c] += W.p[s][c] - W.p[j][c];
  mul_t(P.Rj, w, P.m);

  const T dtj = W.td - __ldg(in.ftd + ij);
  const T vl[2] = {__ldg(in.vel + 2 * ij), __ldg(in.vel + 2 * ij + 1)};
  const T vr[2] = {__ldg(in.vel_r + 2 * ij), __ldg(in.vel_r + 2 * ij + 1)};
  const T ol[2] = {__ldg(in.pts + 3 * ij) - dtj * vl[0],
                   __ldg(in.pts + 3 * ij + 1) - dtj * vl[1]};
  const T orr[2] = {__ldg(in.pts_r + 3 * ij) - dtj * vr[0],
                    __ldg(in.pts_r + 3 * ij + 1) - dtj * vr[1]};
  camera_rows<T, false>(P, W.R[NF], W.p[NF], ol, vl, sinfo, mono_ok, r, J);
  camera_rows<T, true>(P, W.R[NF + 1], W.p[NF + 1], orr, vr, sinfo, st_ok,
                       r + 2, J + 2 * NT);
  return true;
}

template <typename T>
constexpr int kWindowBytes = (int)((sizeof(Window<T>) + 15) / 16 * 16);

template <typename T>
constexpr int kSmemBytes =
    kWindowBytes<T> + kThreads * Stage<T>::kStride * (int)sizeof(T);

// Grid (B, pair blocks of a window): block (b, y) takes pairs
// [128 y, 128 y + 128) of window b, f = pair / 11, j = pair % 11. Adds the
// pairs that read their values to *read_pairs unless it is null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(Inputs<T> in, T sinfo, T* r_out, T* J_out, int F,
                unsigned long long* read_pairs) {
  using V = typename Stage<T>::V;
  constexpr int kStride = Stage<T>::kStride;
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  Window<T>& W = *reinterpret_cast<Window<T>*>(smem);
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  if (t < NF + 2) {
    const size_t k = t < NF ? (size_t)b * NF + t : (size_t)b * 2 + t - NF;
    const T* q = (t < NF ? in.q : in.qic) + 4 * k;
    const T* p = (t < NF ? in.p : in.tic) + 3 * k;
    T qv[4] = {__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3)};
    rotation(qv, W.R[t]);
    for (int c = 0; c < 3; ++c) W.p[t][c] = __ldg(p + c);
  }
  if (t == 0) {
    W.td = __ldg(in.td + b);
    W.reads = 0;
  }
  __syncthreads();

  const int warp = t / 32, lane = t % 32;
  const int n_pairs = F * NF;
  const int first = blockIdx.y * kThreads + warp * 32;   // in the window
  const int n = min(32, n_pairs - first);
  if (n > 0) {
    T* stage = reinterpret_cast<T*>(smem + kWindowBytes<T>)
               + warp * 32 * kStride;
    const size_t g = (size_t)b * n_pairs + first;        // in the batch
    bool read = false;
    if (lane < n) {
      const int pair = first + lane;
      alignas(16) T r[4];
      read = pair_rows(in, W, b, F, pair / NF, pair % NF, sinfo, r,
                       stage + lane * kStride);
      V* rv = reinterpret_cast<V*>(r_out + 4 * (g + lane));
      for (int h = 0; h < 4 / kVec; ++h)
        __stcs(rv + h, *reinterpret_cast<const V*>(r + h * kVec));
    }
    if (read_pairs) {
      const unsigned m = __ballot_sync(0xffffffffu, read);
      if (lane == 0 && m) atomicAdd(&W.reads, __popc(m));
    }
    __syncwarp();
    constexpr int kChunks = NJ / kVec;                   // vectors a pair
    V* dst = reinterpret_cast<V*>(J_out + NJ * g);
    for (int c = lane; c < n * kChunks; c += 32) {
      const int pair = c / kChunks;
      const int k = (c - pair * kChunks) * kVec;
      __stcs(dst + c,
             *reinterpret_cast<const V*>(stage + pair * kStride + k));
    }
  }
  if (read_pairs) {     // the same for every thread of the block
    __syncthreads();
    if (t == 0 && W.reads)
      atomicAdd(read_pairs, (unsigned long long)W.reads);
  }
}

template <typename T>
int launch(const Inputs<T>& in, double sinfo, T* r, T* J,
           unsigned long long* read_pairs, int batch, int F, int device,
           void* stream) {
  if (batch <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  static bool smem_set[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices || !smem_set[device]) {
    err = cudaFuncSetAttribute(rows_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes<T>);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < kMaxDevices) smem_set[device] = true;
  }
  const dim3 grid(batch, (F * NF + kThreads - 1) / kThreads);
  rows_kernel<T><<<grid, kThreads, kSmemBytes<T>, (cudaStream_t)stream>>>(
      in, (T)sinfo, r, J, F, read_pairs);
  return (int)cudaGetLastError();
}

}  // namespace proj_rows

namespace pr = proj_rows;

extern "C" {

// Launch the kernel on `stream` of `device` without synchronising. Every
// input is contiguous with a leading batch axis: p (B, 11, 3), q (B, 11, 4),
// tic (B, 2, 3), qic (B, 2, 4), td (B,), depth (B, F), start (B, F) int32,
// pts and pts_r (B, F, 11, 3), vel and vel_r (B, F, 11, 2), ftd (B, F, 11),
// obs and stereo (B, F, 11) and valid (B, F) bytes of 0 or 1; sinfo is the
// residuals' square-root information. r (B, F, 11, 4) and J
// (B, F, 11, 4, 26) are written whole. Unless read_pairs is null, the
// number of pairs that read their values (a camera's mask on) is added to
// *read_pairs. Returns the CUDA error code of the launch (0 when it was
// accepted).
#define PROJ_ROWS_ENTRY(NAME, T)                                             \
  int NAME(const T* p, const T* q, const T* tic, const T* qic, const T* td, \
           const T* depth, const int32_t* start, const T* pts,              \
           const T* pts_r, const T* vel, const T* vel_r, const T* ftd,      \
           const uint8_t* obs, const uint8_t* stereo, const uint8_t* valid, \
           double sinfo, T* r, T* J, unsigned long long* read_pairs,        \
           int batch, int F, int device, void* stream) {                    \
    const pr::Inputs<T> in{p,     q,   tic,   qic, td,  depth,  start, pts, \
                           pts_r, vel, vel_r, ftd, obs, stereo, valid};     \
    return pr::launch<T>(in, sinfo, r, J, read_pairs, batch, F, device,     \
                         stream);                                           \
  }

PROJ_ROWS_ENTRY(proj_rows_f32, float)
PROJ_ROWS_ENTRY(proj_rows_f64, double)

#undef PROJ_ROWS_ENTRY

const char* proj_rows_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
