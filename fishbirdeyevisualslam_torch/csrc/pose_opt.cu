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
// once) nor operations (44 evaluations over up to 2 x 2048 active
// observations at ~200 flops each, a third of a microsecond at the f32
// peak), but latency: 44 strictly dependent evaluations, each a reduction of
// 28 sums over every row, then a 6x6 solve and a retraction before the next
// one can start (one block on one SM of an H100 took ~8.6 us per evaluation).
//
// Design: a thread block cluster of CLUSTER blocks on CLUSTER SMs.
//   * Rows.  The rows, front 0 .. N-1 then bird N .. N+NB-1, are cut into
//     CLUSTER contiguous slices, one per block, over its ROW_THREADS row
//     threads.  Each loads its first RPT rows (points, measurement,
//     information, valid) into registers once per call and keeps their
//     inlier flags in registers; rows beyond CLUSTER * ROW_THREADS * RPT are
//     read from global memory at each evaluation and keep their flags in the
//     output masks.  An inactive row is skipped on a register flag.
//   * Reduction.  A row warp reduces its threads' 28 sums by a transposing
//     butterfly (at each level a lane keeps half of its values and trades the
//     other half: 31 shuffles, after which lane k holds sum k), and the
//     block's warps are summed in a fixed order.  The block then writes its
//     28 sums into every block's inbox with st.async, an asynchronous store
//     into distributed shared memory that counts its bytes on the receiving
//     block's mbarrier: no fence, no cluster-wide barrier.  A block's
//     finishing threads wait on their own mbarrier for all CLUSTER x 28 sums
//     and sum the inboxes in rank order: every block gets bit-identical sums
//     and takes the same decisions, with no broadcast.  Inboxes and mbarriers
//     alternate by the evaluation's parity.
//   * Off the critical path.  A prior warp computes the prior's log of the
//     pose under evaluation while the row warps work.  A speculation warp
//     computes, meanwhile, the candidate that follows if this one is rejected
//     (the step from the current pose on the current sums at 4 lam), so after
//     a reject the next evaluation starts at once; after an accept every
//     thread solves the 6x6 system (one reciprocal per column) and retracts.
// IEEE f32 throughout (no fast math): accept/reject is decided by err_c < err,
// and the fixed reduction order makes two launches on one input agree bit
// for bit.  A cluster launch that the card refuses is reported, never
// retried on fewer blocks.
//
// Batches (pose_opt_batched): B independent problems of the same shapes in
// one launch, gridDim = (CLUSTER, B), one cluster per problem; blockIdx.y
// moves every input and output pointer to its problem's row and the
// cluster's code is the single problem's.  One cluster fills 8 of the 132
// SMs, so up to 16 problems run at once where B single launches queue one
// after another.  A single problem is the case B = 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;      // blocks: the portable cluster size
constexpr int ROW_THREADS = 256;             // warps 0-7: the rows
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int PRIOR_WARP = ROW_WARPS;        // the prior's log of the pose being evaluated
constexpr int SPEC_WARP = ROW_WARPS + 1;     // the candidate that follows a rejected step
constexpr int THREADS = ROW_THREADS + 64;
constexpr int RPT = 2;          // rows per thread held in registers
constexpr int NH = 21;          // lower triangle of the 6x6 H, row by row
constexpr int NS = NH + 6 + 1;  // H, J^T W e, error
constexpr int NV = 32;          // NS padded to a warp for the butterfly

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
__device__ __forceinline__ Pose retract(const Pose& T, const float* xi) {
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
__device__ __forceinline__ void se3_log(const Pose& T, float* xi) {
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

__device__ __forceinline__ void chol_solve6(const float* H, const float* g, float lam,
                                            float* x) {
  // one correctly rounded reciprocal per column, then products: the divisions
  // of the plain version become multiplications, off the chain of square roots
  float L[6][6], inv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = H[tri(i, i)];
    s = (s + lam * s) + 1e-10f;  // H + lam diag(H) + 1e-10 I
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * L[i][k];
    L[i][i] = sqrtf(fmaxf(s, 1e-12f));
    inv[i] = 1.0f / L[i][i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) {
      float s2 = H[tri(j, i)];
#pragma unroll
      for (int k = 0; k < i; ++k) s2 = s2 - L[j][k] * L[i][k];
      L[j][i] = s2 * inv[i];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = 5; k > i; --k) s = s - L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

// ---- one row: residual, Jacobian, weighted normal-equation terms ---------

// One observation as a thread holds it: a front row (X, u, v, info) or a bird
// row (X, Xc, info); info already carries the view's weight.
struct Row {
  float X[3];
  float m[3];  // front: u, v, unused; bird: Xc
  float info;
  bool bird, valid;
};

struct Obs {
  const float* fXw; const float* fuv; const float* finfo; const bool* fvalid; int n;
  const float* bXw; const float* bXc; const float* binfo; const bool* bvalid; int nb;
  bool* fin; bool* bin;
};

__device__ __forceinline__ Row load_row(const Params& p, const Obs& o, int i) {
  Row r;
  r.bird = i >= o.n;
  if (!r.bird) {
    for (int k = 0; k < 3; ++k) r.X[k] = o.fXw[3 * i + k];
    r.m[0] = o.fuv[2 * i]; r.m[1] = o.fuv[2 * i + 1]; r.m[2] = 0.0f;
    r.info = o.finfo[i] * p.w_front;
    r.valid = o.fvalid[i];
  } else {
    const int j = i - o.n;
    for (int k = 0; k < 3; ++k) {
      r.X[k] = o.bXw[3 * j + k];
      r.m[k] = o.bXc[3 * j + k];
    }
    r.info = o.binfo[j] * p.w_bird;
    r.valid = o.bvalid[j];
  }
  return r;
}

// the row's inlier flag where the thread does not hold it: the output mask
__device__ __forceinline__ bool* mask_of(const Obs& o, int i) {
  return i < o.n ? o.fin + i : o.bin + (i - o.n);
}

__device__ __forceinline__ void transform(const float R[9], const float* t, const float* X,
                                          float* pc) {
  pc[0] = ((R[0] * X[0] + R[1] * X[1]) + R[2] * X[2]) + t[0];
  pc[1] = ((R[3] * X[0] + R[4] * X[1]) + R[5] * X[2]) + t[1];
  pc[2] = ((R[6] * X[0] + R[7] * X[1]) + R[8] * X[2]) + t[2];
}

// a front row's reprojection error at the camera-frame point pc; iz = 1 / z
__device__ __forceinline__ void front_error(const Params& p, const float* pc, const Row& r,
                                            float* iz, float* e) {
  const float z = fabsf(pc[2]) < 1e-6f ? 1e-6f : pc[2];
  *iz = 1.0f / z;
  e[0] = r.m[0] - (p.fx * pc[0] * *iz + p.cx);
  e[1] = r.m[1] - (p.fy * pc[1] * *iz + p.cy);
}

// raw chi2 of a row at (R, t)
__device__ __forceinline__ float row_chi2(const Params& p, const float R[9], const float* t,
                                          const Row& r) {
  float pc[3];
  transform(R, t, r.X, pc);
  if (!r.bird) {
    float iz, e[2];
    front_error(p, pc, r, &iz, e);
    return (e[0] * e[0] + e[1] * e[1]) * r.info;
  }
  const float e0 = r.m[0] - pc[0], e1 = r.m[1] - pc[1], e2 = r.m[2] - pc[2];
  return ((e0 * e0 + e1 * e1) + e2 * e2) * r.info;
}

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

// the row's terms at (R, t) added to acc[NS]
__device__ __forceinline__ void add_row(const Params& p, const float R[9], const float* t,
                                        const Row& r, bool huber, float* acc) {
  float pc[3];
  transform(R, t, r.X, pc);
  if (!r.bird) {
    float iz, e[2];
    front_error(p, pc, r, &iz, e);
    const float chi2 = (e[0] * e[0] + e[1] * e[1]) * r.info;
    const float a = p.fx * iz, b = p.fy * iz;
    const float c = -a * pc[0] * iz, d = -b * pc[1] * iz;
    const float J[2][6] = {{-(c * pc[1]), -(a * pc[2] - c * pc[0]), a * pc[1], -a, 0.0f, -c},
                           {b * pc[2] - d * pc[1], d * pc[0], -(b * pc[0]), 0.0f, -b, -d}};
    add_rows(acc, J, 2, e, irls(chi2, r.info, p, huber));
    acc[NS - 1] += robust(chi2, p, huber);
  } else {
    float e[3];
    for (int k = 0; k < 3; ++k) e[k] = r.m[k] - pc[k];
    const float chi2 = ((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]) * r.info;
    // d(Xc - T X)/dxi = -[-[p]x | I] = [[p]x | -I]
    const float J[3][6] = {{0.0f, -pc[2], pc[1], -1.0f, 0.0f, 0.0f},
                           {pc[2], 0.0f, -pc[0], 0.0f, -1.0f, 0.0f},
                           {-pc[1], pc[0], 0.0f, 0.0f, 0.0f, -1.0f}};
    add_rows(acc, J, 3, e, irls(chi2, r.info, p, huber));
    acc[NS - 1] += robust(chi2, p, huber);
  }
}

// ---- the cluster-wide evaluation -----------------------------------------

struct Shared {
  uint64_t full[2];                  // by evaluation parity: every block's sums and sh.pe are in
  float part[ROW_WARPS][NV];         // per-warp sums
  float inbox[2][CLUSTER][NS];       // every block's sums, by evaluation parity (written remotely)
  float total[2][NS];                // the cluster's sums: current state and candidate
  float pe[7];                       // prior_terms of the pose being evaluated
  float spec[2][8];                  // the candidate after a rejected step (pose, finite),
                                     // by evaluation parity
  int n_valid, n_in;                 // this block's valid front rows; front inliers at the end
};

// The rows a row thread owns: combined row indices begin, begin + ROW_THREADS,
// ... < end.
struct Slice {
  int begin, end;
  Row reg[RPT];  // the first RPT of them
  bool act[RPT];
};

// The prior's terms at the candidate pose T: e = log(T prior^-1) and |e|^2.
__device__ __forceinline__ void prior_terms(const Pose& T, const Pose& prior_inv, float* e) {
  se3_log(compose(T, prior_inv), e);
  e[6] = ((((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]) + e[3] * e[3]) + e[4] * e[4])
         + e[5] * e[5];
}

// Warp reduction of v[NV] by a transposing butterfly: at offset o a lane keeps
// the half of v[0 .. 2o) its lane bit o selects and receives its partner's
// copy of that half.  Afterwards v[0] of lane k is the warp's sum of v[k].
__device__ __forceinline__ float warp_transpose_sum(float* v, int lane) {
#pragma unroll
  for (int o = NV / 2; o >= 1; o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = upper ? v[i] : v[i + o];
      const float keep = upper ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return v[0];
}

// mbarriers in shared memory, filled across the cluster by st.async
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}
// arrive on bar, whose phase then also waits for `bytes` more
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// store v into block `rank`'s copy of *slot asynchronously; the store counts
// 4 bytes on block `rank`'s copy of bar when it lands
__device__ __forceinline__ void st_async_at(float* slot, float v, uint64_t* bar, int rank) {
  asm volatile("{\n.reg .b32 ra, rb;\n"
               "mapa.shared::cluster.u32 ra, %0, %3;\n"
               "mapa.shared::cluster.u32 rb, %2, %3;\n"
               "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [ra], %1, [rb];\n}"
               :: "r"(smem_u32(slot)), "r"(__float_as_uint(v)), "r"(smem_u32(bar)), "r"(rank)
               : "memory");
}
// wait until the phase of parity `parity` of bar has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
// a barrier of the row warps only
__device__ __forceinline__ void rows_barrier() {
  asm volatile("bar.sync 1, %0;" :: "n"(ROW_THREADS) : "memory");
}

__device__ __forceinline__ Pose load_pose(const float* v) {
  Pose T;
  for (int i = 0; i < 4; ++i) T.q[i] = v[i];
  for (int i = 0; i < 3; ++i) T.t[i] = v[4 + i];
  return T;
}

// The candidate of a step from T on the sums Hg at damping lam, and whether
// the step was finite.  Not inlined: one copy serves every caller.
struct Cand {
  Pose T;
  bool finite;
};

__device__ __noinline__ Cand step(Pose T, const float* Hg, float lam) {
  float dx[6];
  chol_solve6(Hg, Hg + NH, lam, dx);
  Cand c;
  c.finite = true;
  for (int k = 0; k < 6; ++k) c.finite = c.finite && isfinite(dx[k]);
  c.T = retract(T, dx);
  return c;
}

__device__ __forceinline__ float next_lam(float lam, bool accept) {
  return fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-10f), 1e6f);
}

// Evaluation number ev at Tc into sh.total[slot]: the sums of J^T W J (lower
// triangle), -(J^T W e) and the robust error over the active rows of the
// whole cluster, plus the prior's terms.  Meanwhile the prior warp computes
// those terms and, with `spec`, the speculation warp computes the candidate
// that follows if Tc is rejected (a step from T on sh.total[1 - slot] at
// next_lam(lam, false)) into sh.spec[ev & 1].  Each block writes its sums into
// every block's inbox by st.async, counted on that block's full[ev & 1]; a
// block's finishing threads wait there for all CLUSTER x NS sums and their
// own prior warp.  Ends with a block barrier, after which every thread may
// read sh.total[slot] and sh.spec[ev & 1], the same values in every block.
__device__ __forceinline__ void evaluate(const Params& p, const Obs& o, const Slice& s,
                                         const Pose& Tc, const Pose& prior_inv, bool huber,
                                         int ev, int slot, bool spec, const Pose& T,
                                         float lam, Shared& sh, cg::cluster_group& cluster) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int parity = ev & 1;
  if (warp == PRIOR_WARP) {
    float pe[7];
    prior_terms(Tc, prior_inv, pe);
    if (lane < 7) sh.pe[lane] = pe[lane];
    // the barrier's phase also waits for every block's NS sums
    if (lane == 0) mbar_arrive_expect(&sh.full[parity], CLUSTER * NS * 4);
    else mbar_arrive(&sh.full[parity]);
  } else if (warp == SPEC_WARP) {
    if (spec) {
      const Cand c = step(T, sh.total[1 - slot], next_lam(lam, false));
      float* out = sh.spec[parity];
      if (lane < 4) out[lane] = c.T.q[lane];
      else if (lane < 7) out[lane] = c.T.t[lane - 4];
      else if (lane == 7) out[7] = c.finite ? 1.0f : 0.0f;
    }
  } else {
    float acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = 0.0f;
    float R[9];
    rot_matrix(Tc.q, R);
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      if (s.act[k]) add_row(p, R, Tc.t, s.reg[k], huber, acc);
    for (int i = s.begin + RPT * ROW_THREADS; i < s.end; i += ROW_THREADS)
      if (*mask_of(o, i)) add_row(p, R, Tc.t, load_row(p, o, i), huber, acc);

    sh.part[warp][lane] = warp_transpose_sum(acc, lane);
    rows_barrier();
    const int k = threadIdx.x;
    if (k < NS) {
      // the block's sum, pushed into every block's inbox
      float b = 0.0f;
      for (int w = 0; w < ROW_WARPS; ++w) b += sh.part[w][k];
      const int rank = (int)cluster.block_rank();
      for (int r = 0; r < CLUSTER; ++r)
        st_async_at(&sh.inbox[parity][rank][k], b, &sh.full[parity], r);
      mbar_wait(&sh.full[parity], (ev >> 1) & 1);
      float v = 0.0f;
      for (int r = 0; r < CLUSTER; ++r) v += sh.inbox[parity][r][k];
      if (k < NH) {
        const bool diag = (k == 0 || k == 2 || k == 5 || k == 9 || k == 14 || k == 20);
        if (diag) v = v + p.prior_info;
      } else if (k < NH + 6) {
        v = -v - p.prior_info * sh.pe[k - NH];
      } else {
        v = v + p.prior_info * sh.pe[6];
      }
      sh.total[slot][k] = v;
    }
  }
  __syncthreads();
}

// re-gate the thread's rows at T on the raw chi2
__device__ __forceinline__ void regate(const Params& p, const Obs& o, Slice& s, const Pose& T) {
  float R[9];
  rot_matrix(T.q, R);
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const Row& r = s.reg[k];
    s.act[k] = r.valid && row_chi2(p, R, T.t, r) <= (r.bird ? p.gate_b : p.gate_f);
  }
  for (int i = s.begin + RPT * ROW_THREADS; i < s.end; i += ROW_THREADS) {
    const Row r = load_row(p, o, i);
    *mask_of(o, i) = r.valid && row_chi2(p, R, T.t, r) <= (r.bird ? p.gate_b : p.gate_f);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
pose_opt_kernel(Params p, const float* __restrict__ T0v, const float* __restrict__ Tpv, Obs o,
                float* __restrict__ Tout, int* n_inliers) {
  // the problem of this cluster: row blockIdx.y of every input and output
  const size_t b = blockIdx.y, n = (size_t)o.n, nb = (size_t)o.nb;
  T0v += 7 * b; Tpv += 7 * b; Tout += 7 * b; n_inliers += b;
  o.fXw += 3 * n * b; o.fuv += 2 * n * b; o.finfo += n * b; o.fvalid += n * b; o.fin += n * b;
  o.bXw += 3 * nb * b; o.bXc += 3 * nb * b; o.binfo += nb * b; o.bvalid += nb * b;
  o.bin += nb * b;
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int m = o.n + o.nb;
  const int per = (m + CLUSTER - 1) / CLUSTER;

  // a row thread's rows: registers for the first RPT, the masks for the rest;
  // the prior and speculation warps own none
  Slice s;
  s.begin = threadIdx.x < ROW_THREADS ? min(m, rank * per) + (int)threadIdx.x : m;
  s.end = min(m, (rank + 1) * per);
  int count = 0;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = s.begin + k * ROW_THREADS;
    const bool own = i < s.end;
    s.reg[k] = own ? load_row(p, o, i) : Row{};
    s.reg[k].valid = own && s.reg[k].valid;
    s.act[k] = s.reg[k].valid;
    count += (s.act[k] && !s.reg[k].bird) ? 1 : 0;
  }
  for (int i = s.begin + RPT * ROW_THREADS; i < s.end; i += ROW_THREADS) {
    const bool v = i < o.n ? o.fvalid[i] : o.bvalid[i - o.n];
    *mask_of(o, i) = v;
    count += (v && i < o.n) ? 1 : 0;
  }
  if (threadIdx.x == 0) {
    sh.n_valid = sh.n_in = 0;
    // per evaluation: the prior warp's lanes, and the bytes of every block's sums
    for (int i = 0; i < 2; ++i) mbar_init(&sh.full[i], 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (count) atomicAdd(&sh.n_valid, count);
  cluster.sync();  // every block runs, with its barriers set, before any push

  const Pose T0 = load_pose(T0v);
  const Pose prior_inv = inverse(load_pose(Tpv));
  Pose T = T0;
  int ev = 0;  // evaluations so far
  for (int round = 0; round < p.rounds; ++round) {
    const bool huber = round < 3;
    if (round < p.rounds - 1) T = T0;
    int cur = 0;  // the slot of the sums at T
    float lam = 1e-4f;
    Cand c{T, false};
    // it = -1 evaluates T itself; it >= 0 the candidate of step it
    for (int it = -1; it < p.iters; ++it) {
      const bool first = it < 0, more = it + 1 < p.iters;
      const int ep = ev & 1;
      evaluate(p, o, s, c.T, prior_inv, huber, ev++, first ? cur : 1 - cur, !first && more, T,
               lam, sh, cluster);
      bool accept = false;
      if (!first) {
        accept = (sh.total[1 - cur][NS - 1] < sh.total[cur][NS - 1]) && c.finite;
        lam = next_lam(lam, accept);
        if (accept) {
          T = c.T;
          cur = 1 - cur;
        }
      }
      if (!more) continue;
      if (first || accept) {
        c = step(T, sh.total[cur], lam);
      } else {  // the speculation warp's candidate
        c.T = load_pose(sh.spec[ep]);
        c.finite = sh.spec[ep][7] != 0.0f;
      }
    }
    regate(p, o, s, T);
  }

  count = 0;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = s.begin + k * ROW_THREADS;
    if (i < s.end) *mask_of(o, i) = s.act[k];
    count += (s.act[k] && !s.reg[k].bird) ? 1 : 0;
  }
  for (int i = s.begin + RPT * ROW_THREADS; i < o.n && i < s.end; i += ROW_THREADS)
    count += o.fin[i] ? 1 : 0;
  if (count) atomicAdd(&sh.n_in, count);
  cluster.sync();  // every block's counts are final
  if (rank == 0 && threadIdx.x == 0) {
    int n_valid = 0, n_in = 0;
    for (int r = 0; r < CLUSTER; ++r) {
      const Shared* rs = cluster.map_shared_rank(&sh, r);
      n_valid += rs->n_valid;
      n_in += rs->n_in;
    }
    const Pose& Tf = n_valid >= 3 ? T : T0;
    for (int i = 0; i < 4; ++i) Tout[i] = Tf.q[i];
    for (int i = 0; i < 3; ++i) Tout[4 + i] = Tf.t[i];
    *n_inliers = n_in;
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
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

// B problems of n front and nb bird rows, each input and output with a
// leading axis of B: T0, Tprior (B, 7) f32; front Xw (B, n, 3), uv (B, n, 2),
// info (B, n) f32, valid (B, n) bool; bird Xw, Xc (B, nb, 3), info (B, nb)
// f32, valid (B, nb) bool.  Writes the poses (B, 7), both inlier masks and
// the front inlier counts (B,).  One cluster of CLUSTER blocks per problem.
// Returns cudaGetLastError(), or the launch's own error.
extern "C" int pose_opt_batched(int B, const float* T0, const float* Tprior, const float* fXw,
                                const float* fuv, const float* finfo, const bool* fvalid, int n,
                                const float* bXw, const float* bXc, const float* binfo,
                                const bool* bvalid, int nb, float fx, float fy, float cx,
                                float cy, float w_front, float w_bird, float delta, float d2,
                                float two_delta, float gate_f, float gate_b, float prior_info,
                                int rounds, int iters, float* Tout, bool* fin, bool* bin,
                                int* n_inliers, void* stream) {
  if (B < 1 || B > 65535 || n < 0 || nb < 0 || rounds < 1 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{fx, fy, cx, cy, w_front, w_bird, delta, d2, two_delta, gate_f, gate_b,
                 prior_info, rounds, iters};
  const Obs o{fXw, fuv, finfo, fvalid, n, bXw, bXc, binfo, bvalid, nb, fin, bin};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, pose_opt_kernel, p, T0, Tprior, o, Tout,
                                             n_inliers);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many of the kernel's clusters the card keeps resident at once: a batch
// larger than this runs in more than one wave.
extern "C" int pose_opt_max_clusters(int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, pose_opt_kernel, &cfg);
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
