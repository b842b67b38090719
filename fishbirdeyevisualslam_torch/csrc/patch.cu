// Patch gather: (N, side, side) windows cut from a 2-D f32 image (the
// vertical atlas of edge-padded pyramid levels) at integer top-left corners.
//
// Replaces the TPU kernel fishbirdeyevisualslam_tpu/ops/pallas_patch.py:extract_patches
// (_patch_kernel); its plain version is vmap(lax.dynamic_slice)
// (ops/features.py:192-194), whose start handling this kernel reproduces:
// a negative corner counts from the end, then is clamped into
// [0, H - side] x [0, W - side].
//
// What bounds it on an H100: bytes.  It moves N * side^2 * 4 B out and about
// as much in (~11 MB for 2048 keypoints at side 37) and computes nothing.
//
// Design: one block per keypoint; consecutive threads copy consecutive
// pixels of a window row, so reads and writes are coalesced.  The TPU
// kernel's aligned (48, 256) window and lane rotates existed for Mosaic's
// aligned vector loads and are gone.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
patch_kernel(const float* __restrict__ img, int h, int w, const int* __restrict__ yx,
             int side, float* __restrict__ out) {
  const int k = blockIdx.x;
  int y = yx[2 * k], x = yx[2 * k + 1];
  if (y < 0) y += h;  // dynamic_slice counts a negative start from the end
  if (x < 0) x += w;
  y = min(max(y, 0), h - side);
  x = min(max(x, 0), w - side);
  const int area = side * side;
  float* dst = out + (size_t)k * area;
  for (int i = threadIdx.x; i < area; i += THREADS) {
    const int r = i / side, c = i - r * side;
    dst[i] = img[(size_t)(y + r) * w + (x + c)];
  }
}

}  // namespace

// img (h, w) f32, yx (n, 2) int32 top-left corners, out (n, side, side) f32.
extern "C" int extract_patches(const float* img, int h, int w, const int* yx, int n,
                               int side, float* out, void* stream) {
  if (n < 0 || side < 1 || side > h || side > w) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  patch_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(img, h, w, yx, side, out);
  return (int)cudaGetLastError();
}
