// Fused projection matchers: one +/-1 bf16 descriptor contraction between a
// frame's keypoints (queries) and projected map points (targets), gated per
// pair by a square search window and an optional octave interval, reduced
// per query without the distance matrix ever reaching device memory.
//
// Replaces two TPU kernels of fishbirdeyevisualslam_tpu/ops/pallas_matcher.py:
//   * fused_projection_match (_proj_match_kernel): running best, second-best
//     and argmin, then max_dist and an optional ratio test       -> DUAL=false
//   * fused_projection_match_dual (_proj_match_kernel_dual): two gated top-1
//     reductions, window r and r * r2_scale, from one contraction -> DUAL=true
// Their plain versions are the dense ops/matcher.py:match references in
// ops/cuda_matcher.py.
//
// What bounds it on an H100: operations.  2048 x 4096 pairs x 256 MACs is
// 4.3 GFLOP of bf16 per call against ~3.5 MB of operands; the gate and the
// reduction add ~20 integer/f32 ops per pair on the CUDA cores, which at this
// width cost more than the tensor-core contraction.
//
// Design: a block owns 64 query rows (16 per warp) and loops over a range of
// 32-column target tiles; the query rows' fragments stay in registers, each
// target tile is staged once in shared memory, contracted with WMMA bf16
// m16n16k16 into f32 (exact: |dot| <= 256), and the 16x32 dot tile goes
// through shared memory to the gate and reduction.  Each (distance, column)
// pair is packed into one 32-bit key (256 - dot) * 65536 + column, unique per
// column, so a plain min gives the distance and the LOWEST column among ties
// (the TPU kernel's packed d * 8192 + col min and strict t1 < b1 merge), and
// the second-best is the min over every other column — it may equal the best.
// The target axis is split over blockIdx.y so ~2 blocks run per SM; a second
// small kernel merges the per-split partial keys (exact, order-free) and
// applies max_dist and the ratio test.  Invalid query rows carry u = -1e6 and
// invalid targets r = -1, so the window test rejects them; pred < 0 targets
// carry the octave interval [-1e9, 1e9].  The TPU kernels' transposed aux
// layout, VMEM tile limits and tile_b <= 8192 packing limit are gone.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int DESC = 256;            // descriptor length
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TA = 16 * WARPS;       // query rows per block
constexpr int TB = 32;               // target columns per tile
constexpr int LDB = DESC + 8;        // padded shared row of a target descriptor (bf16)
constexpr int LDS = TB + 4;          // padded shared row of a warp's dot tile (f32)
constexpr unsigned NONE = 0xFFFFFFFFu;
constexpr float BIG = 1e9f;

// merge two (best, second) key pairs; keys are unique per column
__device__ __forceinline__ void merge2(unsigned& a1, unsigned& a2, unsigned b1, unsigned b2) {
  const unsigned lo = min(a1, b1);
  a2 = min(max(a1, b1), min(a2, b2));
  a1 = lo;
}

template <bool DUAL>
__global__ void __launch_bounds__(THREADS)
proj_match_partial(const __nv_bfloat16* __restrict__ A, const float* __restrict__ au,
                   const float* __restrict__ av, const float* __restrict__ ao, int na,
                   const __nv_bfloat16* __restrict__ B, const float* __restrict__ bu,
                   const float* __restrict__ bv, const float* __restrict__ br,
                   const float* __restrict__ blo, const float* __restrict__ bhi, int nb,
                   int level_window, float r2_scale, int tiles_per_split,
                   unsigned* __restrict__ part1, unsigned* __restrict__ part2) {
  __shared__ __align__(32) __nv_bfloat16 sB[TB * LDB];
  __shared__ __align__(32) float sD[WARPS][16 * LDS];
  __shared__ float sBu[TB], sBv[TB], sBr[TB], sBlo[TB], sBhi[TB];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * TA + warp * 16;

  // the warp's 16 query rows over the whole descriptor, kept in registers
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[DESC / 16];
#pragma unroll
  for (int k = 0; k < DESC / 16; ++k)
    wmma::load_matrix_sync(fa[k], A + (size_t)row0 * DESC + k * 16, DESC);

  // each lane scans row r over half of each tile's columns
  const int r = lane & 15, half = lane >> 4;
  const int row = row0 + r;
  const float qu = row < na ? au[row] : -1e6f;
  const float qv = row < na ? av[row] : 0.f;
  const float qo = row < na ? ao[row] : 0.f;
  unsigned run1 = NONE, run2 = NONE;

  const int n_tiles = (nb + TB - 1) / TB;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * TB;
    for (int i = threadIdx.x; i < TB * (DESC / 8); i += THREADS) {
      const int n = i / (DESC / 8), q = i % (DESC / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c0 + n < nb) val = reinterpret_cast<const uint4*>(B + (size_t)(c0 + n) * DESC)[q];
      reinterpret_cast<uint4*>(sB + n * LDB)[q] = val;
    }
    if (threadIdx.x < TB) {
      const int c = c0 + threadIdx.x;
      const bool in = c < nb;
      sBu[threadIdx.x] = in ? bu[c] : 0.f;
      sBv[threadIdx.x] = in ? bv[c] : 0.f;
      sBr[threadIdx.x] = in ? br[c] : -1.f;
      sBlo[threadIdx.x] = in ? blo[c] : 0.f;
      sBhi[threadIdx.x] = in ? bhi[c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < TB / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < DESC / 16; ++k) {
        wmma::load_matrix_sync(fb, sB + j * 16 * LDB + k * 16, LDB);
        wmma::mma_sync(acc, fa[k], fb, acc);
      }
      wmma::store_matrix_sync(&sD[warp][j * 16], acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    unsigned m1 = NONE, m2 = NONE;
#pragma unroll 4
    for (int cc = 0; cc < 16; ++cc) {
      const int c = half * 16 + cc;
      const float dot = sD[warp][r * LDS + c];
      const float du = fabsf(qu - sBu[c]);
      const float dv = fabsf(qv - sBv[c]);
      const float rb = sBr[c];
      const bool lev = !level_window || (qo >= sBlo[c] && qo <= sBhi[c]);
      const unsigned key = (unsigned)(256 - __float2int_rn(dot)) * 65536u + (unsigned)(c0 + c);
      if (DUAL) {
        const float rw = rb * r2_scale;
        const bool ok_w = lev && du <= rw && dv <= rw;
        if (ok_w && du <= rb && dv <= rb) m1 = min(m1, key);
        if (ok_w) m2 = min(m2, key);
      } else if (lev && du <= rb && dv <= rb) {
        if (key < m1) {
          m2 = m1;
          m1 = key;
        } else if (key < m2) {
          m2 = key;
        }
      }
    }
    const unsigned o1 = __shfl_xor_sync(0xffffffffu, m1, 16);
    const unsigned o2 = __shfl_xor_sync(0xffffffffu, m2, 16);
    if (DUAL) {
      run1 = min(run1, min(m1, o1));
      run2 = min(run2, min(m2, o2));
    } else {
      merge2(m1, m2, o1, o2);
      merge2(run1, run2, m1, m2);
    }
    __syncthreads();  // the next tile overwrites sB and the aux rows
  }
  if (half == 0 && row < na) {
    part1[(size_t)blockIdx.y * na + row] = run1;
    part2[(size_t)blockIdx.y * na + row] = run2;
  }
}

__device__ __forceinline__ float key_dist(unsigned key) {
  return key == NONE ? BIG : (float)((key >> 16) >> 1);
}

__device__ __forceinline__ void emit(unsigned key, bool ok, int row, int* idx, float* dist,
                                     bool* okp) {
  idx[row] = ok ? (int)(key & 0xFFFFu) : -1;
  dist[row] = ok ? key_dist(key) : BIG;
  okp[row] = ok;
}

template <bool DUAL>
__global__ void proj_match_finish(const unsigned* __restrict__ part1,
                                  const unsigned* __restrict__ part2, int splits, int na,
                                  float max_dist, int use_ratio, float ratio,
                                  int* idx1, float* dist1, bool* ok1,
                                  int* idx2, float* dist2, bool* ok2) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= na) return;
  unsigned a1 = NONE, a2 = NONE;
  for (int s = 0; s < splits; ++s) {
    const unsigned b1 = part1[(size_t)s * na + row], b2 = part2[(size_t)s * na + row];
    if (DUAL) {
      a1 = min(a1, b1);
      a2 = min(a2, b2);
    } else {
      merge2(a1, a2, b1, b2);
    }
  }
  if (DUAL) {
    emit(a1, key_dist(a1) <= max_dist, row, idx1, dist1, ok1);
    emit(a2, key_dist(a2) <= max_dist, row, idx2, dist2, ok2);
  } else {
    const float best = key_dist(a1);
    bool ok = best <= max_dist;
    if (use_ratio) ok = ok && best < ratio * key_dist(a2);
    emit(a1, ok, row, idx1, dist1, ok1);
  }
}

}  // namespace

// A (na_pad, 256) bf16 with na_pad a multiple of 64 and rows >= na ignored;
// au/av/ao (na,) f32; B (nb, 256) bf16; bu/bv/br/blo/bhi (nb,) f32;
// part1/part2 (splits, na) uint32 scratch; outputs (na,).  The second output
// set is written only when dual != 0.  Returns cudaGetLastError().
extern "C" int proj_match(int dual, const void* A, const float* au, const float* av,
                          const float* ao, int na, int na_pad, const void* B, const float* bu,
                          const float* bv, const float* br, const float* blo, const float* bhi,
                          int nb, int level_window, float r2_scale, float max_dist,
                          int use_ratio, float ratio, int splits, unsigned* part1,
                          unsigned* part2, int* idx1, float* dist1, bool* ok1, int* idx2,
                          float* dist2, bool* ok2, void* stream) {
  if (na < 0 || nb < 0 || nb > 65536 || splits < 1 || na_pad % TA != 0 || na_pad < na)
    return (int)cudaErrorInvalidValue;
  if (na == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (nb + TB - 1) / TB;
  const int per_split = n_tiles == 0 ? 1 : (n_tiles + splits - 1) / splits;
  const dim3 grid(na_pad / TA, splits);
  const __nv_bfloat16* a = (const __nv_bfloat16*)A;
  const __nv_bfloat16* b = (const __nv_bfloat16*)B;
  if (dual)
    proj_match_partial<true><<<grid, THREADS, 0, st>>>(a, au, av, ao, na, b, bu, bv, br, blo,
                                                       bhi, nb, level_window, r2_scale,
                                                       per_split, part1, part2);
  else
    proj_match_partial<false><<<grid, THREADS, 0, st>>>(a, au, av, ao, na, b, bu, bv, br, blo,
                                                        bhi, nb, level_window, r2_scale,
                                                        per_split, part1, part2);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int fb = (na + 127) / 128;
  if (dual)
    proj_match_finish<true><<<fb, 128, 0, st>>>(part1, part2, splits, na, max_dist, use_ratio,
                                                ratio, idx1, dist1, ok1, idx2, dist2, ok2);
  else
    proj_match_finish<false><<<fb, 128, 0, st>>>(part1, part2, splits, na, max_dist, use_ratio,
                                                 ratio, idx1, dist1, ok1, idx2, dist2, ok2);
  return (int)cudaGetLastError();
}
