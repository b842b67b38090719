// FAST-9/16 at two thresholds + 3x3 non-max suppression, for every pyramid
// level of both views of a frame in ONE launch.
//
// Replaces the TPU kernel fishbirdeyevisualslam_tpu/ops/pallas_fast.py:fast_detect
// (_fast_kernel), whose plain version is ops/fast.py:detect(..., with_raw=True).
//
// What bounds it on an H100: in principle bytes (each pixel read once, 4 B,
// two maps written, 8 B: ~20 MB for the 1.63 M pixels of a frame, 5.8 us),
// in practice instructions: a few hundred per scored pixel (16 circle
// differences, each tested against two thresholds in both directions with
// its excess summed in circle order).  So the design spends instructions on
// little else: every scored pixel is one that an output needs (up to a thin
// ring), the image is read from shared memory at offsets fixed at compile
// time, and the work sits on the FMA pipe where it can (the ALU pipe issues
// half as fast).
//
// Design: a block is one warp and covers a 30 x 16 output tile of one level;
// all levels share one grid through a level table passed by value (each
// level image's own pointer: no copy into one buffer, no per-level launch).
//   * Staging: the warp copies its image window (38 columns x 24 rows: the
//     3 px circle and 1 px NMS halo around the tile) into shared memory, row
//     by row, consecutive lanes on consecutive pixels, every load issued
//     before the first store: no division per element, and the level rows
//     need no alignment.
//   * Scoring: lane l owns column x0 - 1 + l and walks down it, scoring rows
//     -1 .. 16 of the tile (18 scores for 16 outputs).  A score reads the 16
//     circle pixels at constant offsets from the lane's shared-memory
//     pointer.  Each circle difference d gives, per threshold t, u = t - |d|:
//     its sign bit (|d| > t) goes into the threshold's mask by one funnel
//     shift, as d's sign bit goes into a shared sign mask (bright = mask &
//     ~sign, dark = mask & sign), and |u| - u, twice the excess max(|d| - t,
//     0) in one FADD, is added to the bright or the dark sum, in circle order
//     like ops/fast.py.  |d| - t rounds exactly as d - t or -d - t does and
//     halving the doubled sums is exact, so the kernel is bit-exact against
//     the plain version.
//   * NMS from registers: each lane keeps the last three scores of its
//     column; the 3x3 maximum takes the vertical maximum of its neighbours'
//     columns by two shuffles.  Lanes 0 and 31 only feed their neighbours,
//     so a tile is 30 columns wide.  The raw low-threshold map is written as
//     each row is scored.
// On the card, tiles of one warp ran faster than blocks of 2, 4 or 8 warps
// over taller tiles, and than staging row by row while scoring.
// The TPU kernel's row banding and 128-lane padding existed for VMEM and are
// gone.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int TX = 30;                // output columns of a tile (one warp)
constexpr int TY = 16;                // output rows of a tile
constexpr int HALO = 4;               // 3 px circle + 1 px NMS
constexpr int SW = 32 + 6;            // staged columns: the 32 scored columns +- 3
constexpr int SH = TY + 2 * HALO;     // staged rows
constexpr float BONUS = 1e4f;

struct Levels {
  const float* src[MAX_LEVELS]; // the level images
  int n;
  int off[MAX_LEVELS];          // element offset of the level in the flat outputs
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int tiles_x[MAX_LEVELS];
  int block0[MAX_LEVELS + 1];   // first block of each level; block0[n] = grid size
};

// any cyclic run of >= 9 set bits among the 16 circle bits (the order in
// which the bits were appended does not matter: reversing a cycle keeps its
// runs)
__device__ __forceinline__ bool arc9(unsigned b) {
  unsigned m = b | (b << 16);
  unsigned r2 = m & (m >> 1);
  unsigned r4 = r2 & (r2 >> 2);
  unsigned r8 = r4 & (r4 >> 4);
  unsigned r9 = r8 & (m >> 8);
  return (r9 & 0xFFFFu) != 0u;
}

// append the sign bit of x to the mask
__device__ __forceinline__ unsigned push_sign(unsigned bits, float x) {
  return __funnelshift_l(__float_as_uint(x), bits, 1);
}

// The two-threshold FAST score of the pixel at p (shared memory, row stride
// SW): `comb` the ranking score (high-threshold score + BONUS, else the low
// one), `lo` the low-threshold score; 0 where the pixel is no corner.
__device__ __forceinline__ void score_px(const float* p, float th_hi, float th_lo,
                                         float& comb, float& lo) {
  // the 16-point Bresenham circle of radius 3, clockwise from 12 o'clock
  const int cy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int cx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float c = p[0];
  // per threshold t: `any` the circle points with |d| > t; `neg` those with
  // d < 0; bright = any & ~neg, dark = any & neg (|d| > t > 0 fixes the sign)
  unsigned any_hi = 0u, any_lo = 0u, neg = 0u;
  float sb_hi = 0.f, sd_hi = 0.f, sb_lo = 0.f, sd_lo = 0.f;  // twice the sums
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float d = p[cy[k] * SW + cx[k]] - c;
    // u = t - |d| < 0 <=> |d| > t; the excess |d| - t = -u is d - t for a
    // bright point and -d - t for a dark one, rounded alike; |u| - u is twice
    // max(-u, 0) in one FADD, and doubling commutes with the rounding
    const float u_hi = th_hi - fabsf(d), u_lo = th_lo - fabsf(d);
    const float x_hi = fabsf(u_hi) - u_hi, x_lo = fabsf(u_lo) - u_lo;
    any_hi = push_sign(any_hi, u_hi);
    any_lo = push_sign(any_lo, u_lo);
    neg = push_sign(neg, d);
    // each point adds to one direction's sums (0 where its excess is 0),
    // in circle order as ops/fast.py sums
    if (d > 0.f) {
      sb_hi += x_hi;
      sb_lo += x_lo;
    } else {
      sd_hi += x_hi;
      sd_lo += x_lo;
    }
  }
  const bool c_hi = arc9(any_hi & ~neg) || arc9(any_hi & neg);
  const float hi = c_hi ? fmaxf(sb_hi, sd_hi) * 0.5f : 0.f;
  lo = (arc9(any_lo & ~neg) || arc9(any_lo & neg)) ? fmaxf(sb_lo, sd_lo) * 0.5f : 0.f;
  comb = hi > 0.f ? hi + BONUS : lo;
}

__global__ void __launch_bounds__(32)
fast_levels_kernel(float* __restrict__ score, float* __restrict__ raw,
                   const __grid_constant__ Levels L, float th_hi, float th_lo) {
  __shared__ float s_img[SH * SW];

  // the tile's level: the last l with block0[l] <= blockIdx.x
  const int b = blockIdx.x;
  int l = 0;
  for (int step = MAX_LEVELS / 2; step > 0; step >>= 1)
    if (l + step < L.n && L.block0[l + step] <= b) l += step;
  const int h = L.h[l], w = L.w[l];
  const int t = b - L.block0[l];
  const int x0 = (t % L.tiles_x[l]) * TX;
  const int y0 = (t / L.tiles_x[l]) * TY;
  const float* __restrict__ im = L.src[l];
  const int lane = threadIdx.x;

  // stage rows y0 - 4 .. y0 + TY + 3, columns x0 - 4 .. x0 + 33 (zeros
  // outside), one or two pixels of each row per lane
  float v[SH][2];
#pragma unroll
  for (int r = 0; r < SH; ++r) {
    const int gy = y0 - HALO + r;
    const bool row_in = gy >= 0 && gy < h;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = lane + 32 * q, gx = x0 - HALO + c;
      v[r][q] = row_in && c < SW && gx >= 0 && gx < w ? im[(size_t)gy * w + gx] : 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < SH; ++r)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (lane + 32 * q < SW) s_img[r * SW + lane + 32 * q] = v[r][q];
  __syncwarp();

  const int gx = x0 - 1 + lane;        // the lane's column
  const bool col_in = gx >= 3 && gx < w - 3;
  const bool out_col = lane >= 1 && lane <= TX && gx < w;
  const size_t off = (size_t)L.off[l];
  // the lane's pixel in row -1 of the tile
  const float* p = s_img + (HALO - 1) * SW + lane + 3;

  float s_prev2 = 0.f, s_prev1 = 0.f;  // scores of rows j - 2 and j - 1
  for (int j = -1; j <= TY; ++j, p += SW) {
    const int gy = y0 + j;
    float s = 0.f, s_lo = 0.f;
    if (gy >= 3 && gy < h - 3) {       // the same for the whole warp
      score_px(p, th_hi, th_lo, s, s_lo);
      if (!col_in) s = s_lo = 0.f;
    }
    if (j >= 0 && j < TY && out_col && gy < h) raw[off + (size_t)gy * w + gx] = s_lo;
    if (j >= 1) {                      // row j - 1 has both neighbours now
      const float m = fmaxf(fmaxf(s_prev2, s_prev1), s);
      const float mx = fmaxf(m, fmaxf(__shfl_up_sync(0xffffffffu, m, 1),
                                      __shfl_down_sync(0xffffffffu, m, 1)));
      if (out_col && gy - 1 < h)
        score[off + (size_t)(gy - 1) * w + gx] = (s_prev1 >= mx && s_prev1 > 0.f) ? s_prev1 : 0.f;
    }
    s_prev2 = s_prev1;
    s_prev1 = s;
  }
}

}  // namespace

// src: host array of n_levels device pointers, each a contiguous (h, w) f32
// image; score, raw: flat f32 outputs holding the levels back to back at the
// element offsets off; off/h/w: host arrays of n_levels entries.  Returns
// cudaGetLastError().
extern "C" int fast_levels(const float* const* src, float* score, float* raw, int n_levels,
                           const int* off, const int* h, const int* w,
                           float th_hi, float th_lo, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels L = {};
  L.n = n_levels;
  int blocks = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (h[l] < 1 || w[l] < 1) return (int)cudaErrorInvalidValue;
    L.src[l] = src[l];
    L.off[l] = off[l];
    L.h[l] = h[l];
    L.w[l] = w[l];
    L.tiles_x[l] = (w[l] + TX - 1) / TX;
    L.block0[l] = blocks;
    blocks += L.tiles_x[l] * ((h[l] + TY - 1) / TY);
  }
  L.block0[n_levels] = blocks;
  fast_levels_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>(score, raw, L, th_hi, th_lo);
  return (int)cudaGetLastError();
}
