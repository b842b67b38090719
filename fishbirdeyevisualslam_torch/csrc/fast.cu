// FAST-9/16 at two thresholds + 3x3 non-max suppression, for every pyramid
// level of both views of a frame in ONE launch.
//
// Replaces the TPU kernel fishbirdeyevisualslam_tpu/ops/pallas_fast.py:fast_detect
// (_fast_kernel), whose plain version is ops/fast.py:detect(..., with_raw=True).
//
// What bounds it on an H100: bytes.  Each pixel is read once (4 B) and two
// maps are written (8 B): 12 B per pixel, ~20 MB for the 1.63 M pixels of a
// frame, against ~100 simple f32/int ops per pixel.  At that size the launch
// itself is a large share of the time, so all levels share one grid through
// a level table passed by value (no host-to-device copy, no per-level launch).
// The table holds each level image's own pointer, so the levels are read
// where the pyramid left them: no copy into one buffer before the launch.
//
// Design: one thread per output pixel over a 32x8 tile.  The tile plus a 4-px
// halo (3 px for the circle, 1 px for the NMS) is staged once in shared
// memory; the threads compute both thresholds' bitmasks and scores for the
// tile plus a 1-px ring (so the NMS needs no neighbour tile), write the raw
// low-threshold map, synchronise, and run the NMS from shared memory.  The
// TPU kernel's row banding and 128-lane padding existed for VMEM and are gone.
// The 16 circle terms are summed in circle order like ops/fast.py.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int TX = 32;              // output tile width
constexpr int TY = 8;               // output tile height
constexpr int HALO = 4;             // 3 px circle + 1 px NMS
constexpr int SW = TX + 2 * HALO;   // staged image tile
constexpr int SH = TY + 2 * HALO;
constexpr int RW = TX + 2;          // score region: tile + 1 px ring
constexpr int RH = TY + 2;
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

// any cyclic run of >= 9 set bits among the 16 circle bits
__device__ __forceinline__ bool arc9(unsigned b) {
  unsigned m = b | (b << 16);
  unsigned r2 = m & (m >> 1);
  unsigned r4 = r2 & (r2 >> 2);
  unsigned r8 = r4 & (r4 >> 4);
  unsigned r9 = r8 & (m >> 8);
  return (r9 & 0xFFFFu) != 0u;
}

__global__ void __launch_bounds__(TX * TY)
fast_levels_kernel(float* __restrict__ score, float* __restrict__ raw, Levels L,
                   float th_hi, float th_lo) {
  __shared__ float s_img[SH][SW];
  __shared__ float s_sc[RH][RW];

  const int b = blockIdx.x;
  int l = 0;
  while (l + 1 < L.n && b >= L.block0[l + 1]) ++l;
  const int h = L.h[l], w = L.w[l];
  const size_t off = (size_t)L.off[l];
  const int t = b - L.block0[l];
  const int x0 = (t % L.tiles_x[l]) * TX;
  const int y0 = (t / L.tiles_x[l]) * TY;
  const float* __restrict__ im = L.src[l];
  const int tid = threadIdx.x;

  for (int i = tid; i < SH * SW; i += TX * TY) {
    const int yy = i / SW, xx = i % SW;
    const int gy = y0 - HALO + yy, gx = x0 - HALO + xx;
    s_img[yy][xx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? im[(size_t)gy * w + gx] : 0.f;
  }
  __syncthreads();

  const int cy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int cx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  for (int i = tid; i < RH * RW; i += TX * TY) {
    const int yy = i / RW, xx = i % RW;
    const int gy = y0 - 1 + yy, gx = x0 - 1 + xx;
    float s_hi = 0.f, s_lo = 0.f;
    if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3) {
      const int sy = yy + HALO - 1, sx = xx + HALO - 1;
      const float c = s_img[sy][sx];
      unsigned bb_hi = 0u, bd_hi = 0u, bb_lo = 0u, bd_lo = 0u;
      float sb_hi = 0.f, sd_hi = 0.f, sb_lo = 0.f, sd_lo = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float d = s_img[sy + cy[k]][sx + cx[k]] - c;
        if (d > th_hi) { bb_hi |= 1u << k; sb_hi += d - th_hi; }
        if (d < -th_hi) { bd_hi |= 1u << k; sd_hi += -d - th_hi; }
        if (d > th_lo) { bb_lo |= 1u << k; sb_lo += d - th_lo; }
        if (d < -th_lo) { bd_lo |= 1u << k; sd_lo += -d - th_lo; }
      }
      if (arc9(bb_hi) || arc9(bd_hi)) s_hi = fmaxf(sb_hi, sd_hi);
      if (arc9(bb_lo) || arc9(bd_lo)) s_lo = fmaxf(sb_lo, sd_lo);
    }
    s_sc[yy][xx] = s_hi > 0.f ? s_hi + BONUS : s_lo;
    if (yy >= 1 && yy <= TY && xx >= 1 && xx <= TX && gy < h && gx < w)
      raw[off + (size_t)gy * w + gx] = s_lo;
  }
  __syncthreads();

  const int ty = tid / TX, tx = tid % TX;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy < h && gx < w) {
    const float s = s_sc[ty + 1][tx + 1];
    float mx = s;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, s_sc[ty + dy][tx + dx]);
    score[off + (size_t)gy * w + gx] = (s >= mx && s > 0.f) ? s : 0.f;
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
  Levels L;
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
  fast_levels_kernel<<<blocks, TX * TY, 0, (cudaStream_t)stream>>>(score, raw, L, th_hi,
                                                                   th_lo);
  return (int)cudaGetLastError();
}
