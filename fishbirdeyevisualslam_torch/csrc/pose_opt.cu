// Fused per-frame pose optimisation: the whole 4 x 10 Levenberg-Marquardt of
// one SE3 pose (Optimizer::PoseOptimizationWithBird) in one launch, with no
// host read between iterations.
//
// Replaces the TPU kernel
// fishbirdeyevisualslam_tpu/solvers/pallas_pose_opt.py:pose_optimization_fused
// (_make_kernel); its plain version is solvers/pose_opt.py:pose_optimization
// of this package.  Per call:
//   * rounds 0 .. R-2 restart from the seed with the current inlier set, the
//     last round continues from the previous round's pose;
//   * Huber (delta^2 = 5.991) in rounds 0-2 only;
//   * per evaluation, one pass over the observations gives the 21 + 6
//     normal-equation sums and the robustified error;
//   * H + lam * diag(H) + 1e-10, an unrolled 6x6 Cholesky, the left-
//     multiplicative retraction, accept when err_c < err and the step is
//     finite; lam x0.5 on accept, x4 on reject, clamped to [1e-10, 1e6];
//   * after each round, re-gate on the raw chi2 (front <= 1.5 wF, bird
//     <= 5.991 wB);
//   * the seed comes back when fewer than 3 front observations are valid.
// The soft SE3 prior uses the exact SO3 / SE3 log of geometry/se3.py (atan2),
// where the TPU kernel had a 7-term atan series; the retraction and the log
// follow geometry/se3.py's operation order and small-angle branches.
//
// What bounds it on an H100: neither bytes (~115 KB of observations, read
// from L1 after the first pass) nor operations (44 evaluations over up to
// 2 x 2048 active observations at ~200 flops each, a third of a microsecond
// at the f32 peak), but latency: 44 dependent block-wide reductions, each
// followed by a 6x6 solve, on one SM.
//
// Design: one block of THREADS threads.  Thread k owns observations k,
// k + THREADS, ...; its front and bird inlier flags live in the output masks,
// which it alone reads and writes.  An evaluation accumulates 28 partial sums
// per thread, reduces them by warp shuffles, then across warps through
// shared memory in a fixed order, into one of two shared buffers: the
// current state and the candidate, so that accepting a step flips an index
// instead of copying.  Every thread then solves the 6x6 system and retracts
// redundantly: all read the same sums, so all take the same decisions, and
// no broadcast is needed.  The TPU kernel's lane padding to 128 and its z = 1
// fill of padded rows are gone: the loops run over the exact N and NB.
// IEEE f32 throughout (no fast math): accept/reject is decided by err_c < err.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NH = 21;          // lower triangle of the 6x6 H, row by row
constexpr int NS = NH + 6 + 1;  // H, J^T W e, error

struct Pose {
  float q[4];  // w, x, y, z
  float t[3];
};

struct Params {
  float fx, fy, cx, cy;
  float w_front, w_bird;
  float delta, d2, two_delta;  // Huber delta, delta^2, 2 delta
  float gate_f, gate_b;        // re-gate thresholds on the raw chi2
  float prior_info;
  int rounds, iters;
};

// ---- SE3, in geometry/se3.py's operation order --------------------------

__device__ __forceinline__ void quat_mul(const float* a, const float* b, float* out) {
  const float w = ((a[0] * b[0] + -(a[1] * b[1])) + -(a[2] * b[2])) + -(a[3] * b[3]);
  const float x = ((a[0] * b[1] + a[1] * b[0]) + a[2] * b[3]) + -(a[3] * b[2]);
  const float y = ((a[0] * b[2] + -(a[1] * b[3])) + a[2] * b[0]) + a[3] * b[1];
  const float z = ((a[0] * b[3] + a[1] * b[2]) + -(a[2] * b[1])) + a[3] * b[0];
  out[0] = w; out[1] = x; out[2] = y; out[3] = z;
}

__device__ __forceinline__ void quat_rotate(const float* q, const float* v, float* out) {
  const float qv[4] = {0.0f, v[0], v[1], v[2]};
  const float qc[4] = {q[0], -q[1], -q[2], -q[3]};
  float m[4], r[4];
  quat_mul(q, qv, m);
  quat_mul(m, qc, r);
  out[0] = r[1]; out[1] = r[2]; out[2] = r[3];
}

__device__ __forceinline__ void quat_normalize(float* q) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

// T1 * T2 (T2 applied first)
__device__ __forceinline__ Pose compose(const Pose& a, const Pose& b) {
  Pose out;
  quat_mul(a.q, b.q, out.q);
  float r[3];
  quat_rotate(a.q, b.t, r);
  for (int i = 0; i < 3; ++i) out.t[i] = r[i] + a.t[i];
  return out;
}

__device__ __forceinline__ Pose inverse(const Pose& a) {
  Pose out;
  out.q[0] = a.q[0]; out.q[1] = -a.q[1]; out.q[2] = -a.q[2]; out.q[3] = -a.q[3];
  float r[3];
  quat_rotate(out.q, a.t, r);
  for (int i = 0; i < 3; ++i) out.t[i] = -r[i];
  return out;
}

// W = [w]x and W @ W
__device__ __forceinline__ void skew_sq(const float* w, float W[3][3], float W2[3][3]) {
  W[0][0] = 0.0f;  W[0][1] = -w[2]; W[0][2] = w[1];
  W[1][0] = w[2];  W[1][1] = 0.0f;  W[1][2] = -w[0];
  W[2][0] = -w[1]; W[2][1] = w[0];  W[2][2] = 0.0f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = (W[i][0] * W[0][j] + W[i][1] * W[1][j]) + W[i][2] * W[2][j];
}

// out = (I + a W + b W2) v
__device__ __forceinline__ void apply_iab(float a, float b, const float W[3][3],
                                          const float W2[3][3], const float* v, float* out) {
  for (int i = 0; i < 3; ++i) {
    float s = 0.0f;
    for (int j = 0; j < 3; ++j) {
      const float m = ((i == j ? 1.0f : 0.0f) + a * W[i][j]) + b * W2[i][j];
      s = s + m * v[j];
    }
    out[i] = s;
  }
}

// exp(xi) * T, normalised (se3.retract)
__device__ Pose retract(const Pose& T, const float* xi) {
  const float* om = xi;
  const float th2 = (om[0] * om[0] + om[1] * om[1]) + om[2] * om[2];
  const bool small = th2 < 1e-12f;
  const float safe2 = small ? 1.0f : th2;
  const float th = sqrtf(safe2);
  const float half = 0.5f * th;
  const float k = small ? 0.5f - th2 / 48.0f : sinf(half) / th;
  Pose E;
  E.q[0] = small ? 1.0f - th2 / 8.0f : cosf(half);
  E.q[1] = k * om[0]; E.q[2] = k * om[1]; E.q[3] = k * om[2];
  quat_normalize(E.q);
  float W[3][3], W2[3][3];
  skew_sq(om, W, W2);
  const float A = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / safe2;
  const float B = small ? 1.0f / 6.0f - th2 / 120.0f : (th - sinf(th)) / (safe2 * th);
  apply_iab(A, B, W, W2, xi + 3, E.t);
  Pose out = compose(E, T);
  quat_normalize(out.q);
  return out;
}

// se3.log(T) -> (omega, upsilon)
__device__ void se3_log(const Pose& T, float* xi) {
  const float w0 = T.q[0];
  const float s = (w0 == 0.0f) ? 1.0f : (w0 > 0.0f ? 1.0f : -1.0f);
  const float q[4] = {T.q[0] * s, T.q[1] * s, T.q[2] * s, T.q[3] * s};
  const float w = fminf(fmaxf(q[0], -1.0f), 1.0f);
  const float vn2 = (q[1] * q[1] + q[2] * q[2]) + q[3] * q[3];
  const bool vsmall = vn2 < 1e-18f;
  const float vn = sqrtf(vsmall ? 1.0f : vn2);
  const float theta = 2.0f * atan2f(vn, w);
  const float scale = vsmall ? 2.0f / fmaxf(w, 1e-12f) : theta / vn;
  float om[3] = {scale * q[1], scale * q[2], scale * q[3]};
  const float th2 = (om[0] * om[0] + om[1] * om[1]) + om[2] * om[2];
  const bool small = th2 < 1e-12f;
  const float safe2 = small ? 1.0f : th2;
  const float th = sqrtf(safe2);
  const float half = 0.5f * th;
  const float cot = half * cosf(half) / sinf(half);
  const float kk = small ? 1.0f / 12.0f + th2 / 720.0f : (1.0f - cot) / safe2;
  float W[3][3], W2[3][3];
  skew_sq(om, W, W2);
  for (int i = 0; i < 3; ++i) xi[i] = om[i];
  apply_iab(-0.5f, kk, W, W2, T.t, xi + 3);
}

__device__ __forceinline__ void rot_matrix(const float* q, float R[9]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - w * z); R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z); R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y); R[7] = 2 * (y * z + w * x); R[8] = 1 - 2 * (x * x + y * y);
}

// ---- the 6x6 solve, in solvers/pose_opt.py:_chol_solve6's order ----------

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }  // j <= i

__device__ void chol_solve6(const float* H, const float* g, float lam, float* x) {
  float L[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = H[tri(i, i)];
    s = (s + lam * s) + 1e-10f;  // H + lam diag(H) + 1e-10 I
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * L[i][k];
    L[i][i] = sqrtf(fmaxf(s, 1e-12f));
#pragma unroll
    for (int j = i + 1; j < 6; ++j) {
      float s2 = H[tri(j, i)];
#pragma unroll
      for (int k = 0; k < i; ++k) s2 = s2 - L[j][k] * L[i][k];
      L[j][i] = s2 / L[i][i];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = 5; k > i; --k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// ---- one evaluation: normal equations + robustified error ---------------

__device__ __forceinline__ void add_rows(float* acc, const float (*J)[6], int rows,
                                         const float* e, float w) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = 0.0f;
      for (int r = 0; r < rows; ++r) s = s + J[r][i] * J[r][j];
      acc[tri(i, j)] += w * s;
    }
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s = s + J[r][i] * e[r];
    acc[NH + i] += w * s;
  }
}

__device__ __forceinline__ float robust(float chi2, const Params& p, bool huber) {
  if (!huber) return chi2;
  return chi2 > p.d2 ? p.two_delta * sqrtf(fmaxf(chi2, 0.0f)) - p.d2 : chi2;
}

__device__ __forceinline__ float irls(float chi2, float info, const Params& p, bool huber) {
  if (!huber) return info;
  const float h = chi2 <= p.d2 ? 1.0f : p.delta / sqrtf(fmaxf(chi2, 1e-12f));
  return h * info;
}

struct Obs {
  const float* fXw; const float* fuv; const float* finfo; int n;
  const float* bXw; const float* bXc; const float* binfo; int nb;
  bool* fact; bool* bact;
};

__device__ __forceinline__ void front_residual(const Params& p, const float R[9], const float* t,
                                              const Obs& o, int i, float* pc, float* z,
                                              float* e, float* chi2) {
  const float X0 = o.fXw[3 * i], X1 = o.fXw[3 * i + 1], X2 = o.fXw[3 * i + 2];
  pc[0] = ((R[0] * X0 + R[1] * X1) + R[2] * X2) + t[0];
  pc[1] = ((R[3] * X0 + R[4] * X1) + R[5] * X2) + t[1];
  pc[2] = ((R[6] * X0 + R[7] * X1) + R[8] * X2) + t[2];
  *z = fabsf(pc[2]) < 1e-6f ? 1e-6f : pc[2];
  e[0] = o.fuv[2 * i] - (p.fx * pc[0] / *z + p.cx);
  e[1] = o.fuv[2 * i + 1] - (p.fy * pc[1] / *z + p.cy);
  *chi2 = (e[0] * e[0] + e[1] * e[1]) * (o.finfo[i] * p.w_front);
}

__device__ __forceinline__ void bird_residual(const Params& p, const float R[9], const float* t,
                                             const Obs& o, int i, float* pc, float* e,
                                             float* chi2) {
  const float X0 = o.bXw[3 * i], X1 = o.bXw[3 * i + 1], X2 = o.bXw[3 * i + 2];
  pc[0] = ((R[0] * X0 + R[1] * X1) + R[2] * X2) + t[0];
  pc[1] = ((R[3] * X0 + R[4] * X1) + R[5] * X2) + t[1];
  pc[2] = ((R[6] * X0 + R[7] * X1) + R[8] * X2) + t[2];
  for (int k = 0; k < 3; ++k) e[k] = o.bXc[3 * i + k] - pc[k];
  *chi2 = ((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]) * (o.binfo[i] * p.w_bird);
}

// Evaluate at T into out[NS] (shared): sum of J^T W J (lower triangle),
// -(J^T W e) and the robust error over the active observations, plus the
// prior's terms.  Ends with a barrier, after which every thread may read out.
__device__ void evaluate(const Params& p, const Obs& o, const Pose& T, const Pose& prior_inv,
                         bool huber, float (*part)[NS], float* out) {
  float acc[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) acc[k] = 0.0f;
  float R[9];
  rot_matrix(T.q, R);
  for (int i = threadIdx.x; i < o.n; i += THREADS) {
    if (!o.fact[i]) continue;
    float pc[3], z, e[2], chi2;
    front_residual(p, R, T.t, o, i, pc, &z, e, &chi2);
    const float info = o.finfo[i] * p.w_front;
    const float a = p.fx / z, b = p.fy / z;
    const float c = -p.fx * pc[0] / (z * z), d = -p.fy * pc[1] / (z * z);
    const float J[2][6] = {{-(c * pc[1]), -(a * pc[2] - c * pc[0]), a * pc[1], -a, 0.0f, -c},
                           {b * pc[2] - d * pc[1], d * pc[0], -(b * pc[0]), 0.0f, -b, -d}};
    add_rows(acc, J, 2, e, irls(chi2, info, p, huber));
    acc[NS - 1] += robust(chi2, p, huber);
  }
  for (int i = threadIdx.x; i < o.nb; i += THREADS) {
    if (!o.bact[i]) continue;
    float pc[3], e[3], chi2;
    bird_residual(p, R, T.t, o, i, pc, e, &chi2);
    const float info = o.binfo[i] * p.w_bird;
    // d(Xc - T X)/dxi = -[-[p]x | I] = [[p]x | -I]
    const float J[3][6] = {{0.0f, -pc[2], pc[1], -1.0f, 0.0f, 0.0f},
                           {pc[2], 0.0f, -pc[0], 0.0f, -1.0f, 0.0f},
                           {-pc[1], pc[0], 0.0f, 0.0f, 0.0f, -1.0f}};
    add_rows(acc, J, 3, e, irls(chi2, info, p, huber));
    acc[NS - 1] += robust(chi2, p, huber);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NS) {
    const int k = threadIdx.x;
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += part[w][k];
    float e[6];
    se3_log(compose(T, prior_inv), e);
    if (k < NH) {
      const bool diag = (k == 0 || k == 2 || k == 5 || k == 9 || k == 14 || k == 20);
      if (diag) s = s + p.prior_info;
    } else if (k < NH + 6) {
      s = -s - p.prior_info * e[k - NH];
    } else {
      const float ee = ((((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]) + e[3] * e[3])
                        + e[4] * e[4]) + e[5] * e[5];
      s = s + p.prior_info * ee;
    }
    out[k] = s;
  }
  __syncthreads();
}

// re-gate the thread's observations at T on the raw chi2
__device__ void regate(const Params& p, const Obs& o, const bool* fvalid, const bool* bvalid,
                       const Pose& T) {
  float R[9];
  rot_matrix(T.q, R);
  for (int i = threadIdx.x; i < o.n; i += THREADS) {
    float pc[3], z, e[2], chi2;
    front_residual(p, R, T.t, o, i, pc, &z, e, &chi2);
    o.fact[i] = fvalid[i] && chi2 <= p.gate_f;
  }
  for (int i = threadIdx.x; i < o.nb; i += THREADS) {
    float pc[3], e[3], chi2;
    bird_residual(p, R, T.t, o, i, pc, e, &chi2);
    o.bact[i] = bvalid[i] && chi2 <= p.gate_b;
  }
}

__device__ __forceinline__ Pose load_pose(const float* v) {
  Pose T;
  for (int i = 0; i < 4; ++i) T.q[i] = v[i];
  for (int i = 0; i < 3; ++i) T.t[i] = v[4 + i];
  return T;
}

__global__ void __launch_bounds__(THREADS)
pose_opt_kernel(Params p, const float* __restrict__ T0v, const float* __restrict__ Tpv,
                const float* __restrict__ fXw, const float* __restrict__ fuv,
                const float* __restrict__ finfo, const bool* __restrict__ fvalid, int n,
                const float* __restrict__ bXw, const float* __restrict__ bXc,
                const float* __restrict__ binfo, const bool* __restrict__ bvalid, int nb,
                float* __restrict__ Tout, bool* fin, bool* bin, int* n_inliers) {
  __shared__ float part[WARPS][NS];
  __shared__ float buf[2][NS];
  __shared__ int n_valid, n_in;  // valid front rows; front inliers at the end
  const Obs o{fXw, fuv, finfo, n, bXw, bXc, binfo, nb, fin, bin};
  if (threadIdx.x == 0) n_valid = n_in = 0;
  int count = 0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    fin[i] = fvalid[i];
    count += fvalid[i] ? 1 : 0;
  }
  for (int i = threadIdx.x; i < nb; i += THREADS) bin[i] = bvalid[i];
  __syncthreads();
  atomicAdd(&n_valid, count);

  const Pose T0 = load_pose(T0v);
  const Pose prior_inv = inverse(load_pose(Tpv));
  Pose T = T0;
  for (int round = 0; round < p.rounds; ++round) {
    const bool huber = round < 3;
    if (round < p.rounds - 1) T = T0;
    int cur = 0;
    evaluate(p, o, T, prior_inv, huber, part, buf[cur]);
    float lam = 1e-4f;
    for (int it = 0; it < p.iters; ++it) {
      float dx[6];
      chol_solve6(buf[cur], buf[cur] + NH, lam, dx);
      bool finite = true;
      for (int k = 0; k < 6; ++k) finite = finite && isfinite(dx[k]);
      const Pose Tc = retract(T, dx);
      evaluate(p, o, Tc, prior_inv, huber, part, buf[1 - cur]);
      const bool accept = (buf[1 - cur][NS - 1] < buf[cur][NS - 1]) && finite;
      if (accept) {
        T = Tc;
        cur = 1 - cur;
      }
      lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-10f), 1e6f);
    }
    regate(p, o, fvalid, bvalid, T);
  }
  count = 0;
  for (int i = threadIdx.x; i < n; i += THREADS) count += fin[i] ? 1 : 0;
  atomicAdd(&n_in, count);
  __syncthreads();
  if (threadIdx.x == 0) {
    const Pose& Tf = n_valid >= 3 ? T : T0;
    for (int i = 0; i < 4; ++i) Tout[i] = Tf.q[i];
    for (int i = 0; i < 3; ++i) Tout[4 + i] = Tf.t[i];
    *n_inliers = n_in;
  }
}

// retract(T_i, dx_i) and log(T_i * Tp_i^-1) for n poses: the kernel's own
// SE3 functions, exposed so that they can be held against geometry/se3.py
__global__ void se3_check_kernel(const float* T, const float* dx, const float* Tp, int n,
                                 float* Tret, float* logrel) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pose R = retract(load_pose(T + 7 * i), dx + 6 * i);
  for (int k = 0; k < 4; ++k) Tret[7 * i + k] = R.q[k];
  for (int k = 0; k < 3; ++k) Tret[7 * i + 4 + k] = R.t[k];
  se3_log(compose(load_pose(T + 7 * i), inverse(load_pose(Tp + 7 * i))), logrel + 6 * i);
}

}  // namespace

// T0, Tprior (7,) f32; front Xw (n, 3), uv (n, 2), info (n,) f32, valid (n,)
// bool; bird Xw, Xc (nb, 3), info (nb,) f32, valid (nb,) bool.  Writes the
// pose (7,), both inlier masks and the front inlier count.  Returns
// cudaGetLastError().
extern "C" int pose_opt(const float* T0, const float* Tprior, const float* fXw,
                        const float* fuv, const float* finfo, const bool* fvalid, int n,
                        const float* bXw, const float* bXc, const float* binfo,
                        const bool* bvalid, int nb, float fx, float fy, float cx, float cy,
                        float w_front, float w_bird, float delta, float d2, float two_delta,
                        float gate_f, float gate_b, float prior_info, int rounds, int iters,
                        float* Tout, bool* fin, bool* bin, int* n_inliers, void* stream) {
  if (n < 0 || nb < 0 || rounds < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  const Params p{fx, fy, cx, cy, w_front, w_bird, delta, d2, two_delta, gate_f, gate_b,
                 prior_info, rounds, iters};
  pose_opt_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      p, T0, Tprior, fXw, fuv, finfo, fvalid, n, bXw, bXc, binfo, bvalid, nb, Tout, fin, bin,
      n_inliers);
  return (int)cudaGetLastError();
}

// T (n, 7), dx (n, 6), Tp (n, 7) f32 -> Tret (n, 7), logrel (n, 6).
extern "C" int se3_check(const float* T, const float* dx, const float* Tp, int n, float* Tret,
                         float* logrel, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  se3_check_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(T, dx, Tp, n, Tret,
                                                                       logrel);
  return (int)cudaGetLastError();
}
