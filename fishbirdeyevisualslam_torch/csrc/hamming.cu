// Packed Hamming kernels: ORB descriptors kept as (N, 8) 32-bit words,
// distances by XOR + popcount on the CUDA cores.
//
// Replaces two TPU kernels of fishbirdeyevisualslam_tpu/ops/pallas_matcher.py:
//   * hamming_matrix_packed (_hamming_kernel): the full (Na, Nb) f32 matrix;
//   * fused_masked_match (_fused_match_kernel): a square window |du|, |dv| <= r
//     and a running best / second-best / argmin per query, the matrix never
//     written.
// Their plain versions are in ops/cuda_matcher.py (a byte-table popcount and
// ops/matcher.py:window_mask plus a min).
//
// What bounds them on an H100:
//   * the matrix: bytes, its Na x Nb x 4 B output (134 MB at 2048 x 16384,
//     40 us at 3.35 TB/s); the 8 popcounts per entry run at 16 per clock per
//     SM, which is of the same order;
//   * the masked match: operations, the window test on every pair (~6 ops);
//     the popcounts only run where the window passes (~1% of pairs at
//     radius 50 over a 900 px square).
//
// Design:
//   * matrix: a block owns 32 query rows (staged in shared memory) and 256
//     target columns, one per thread, whose 8 words stay in registers; each
//     thread writes its column of the 32 rows, so a warp writes 128
//     consecutive bytes per row;
//   * masked match: one thread per query, its words and position in
//     registers; target tiles of 256 are staged in shared memory and read by
//     every thread at the same address (a broadcast).  Each (distance, column)
//     pair is packed into one 32-bit key d << 20 | column, unique per column,
//     so a plain min gives the least distance and the LOWEST column among
//     ties, and the second-best is the least key over every other column (it
//     may equal the best distance) — the TPU kernel's strict t1 < b1 merge
//     across tiles.  The target axis is split over blockIdx.y so several
//     blocks run per SM, and a second small kernel merges the per-split keys
//     (exact, in any order).  Invalid and out-of-range targets carry a NaN
//     position, so the window test rejects them, as the TPU kernel's 1e6
//     fill did.
// The TPU kernels' padding of both axes to (256, 512) tiles is gone: the
// kernels mask the ragged edges themselves.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 8;
constexpr int H_THREADS = 256;  // target columns per matrix block
constexpr int H_ROWS = 32;      // query rows per matrix block
constexpr int M_THREADS = 128;  // queries per match block
constexpr int M_TILE = 256;     // targets staged per tile
constexpr int COL_BITS = 20;
constexpr unsigned NONE = 0xFFFFFFFFu;
constexpr float BIG = 1e9f;

__device__ __forceinline__ int hamming(const uint32_t* a, const uint32_t* b) {
  int d = 0;
#pragma unroll
  for (int w = 0; w < WORDS; ++w) d += __popc(a[w] ^ b[w]);
  return d;
}

__global__ void __launch_bounds__(H_THREADS)
hamming_matrix_kernel(const uint32_t* __restrict__ A, int na, const uint32_t* __restrict__ B,
                      int nb, float* __restrict__ out) {
  __shared__ uint32_t sA[H_ROWS][WORDS];
  const int row0 = blockIdx.y * H_ROWS;
  const int col = blockIdx.x * H_THREADS + threadIdx.x;
  for (int k = threadIdx.x; k < H_ROWS * WORDS; k += H_THREADS) {
    const int r = row0 + k / WORDS;
    sA[k / WORDS][k % WORDS] = r < na ? A[(size_t)r * WORDS + k % WORDS] : 0u;
  }
  __syncthreads();
  if (col >= nb) return;
  uint32_t b[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) b[w] = B[(size_t)col * WORDS + w];
  const int rows = min(H_ROWS, na - row0);
  for (int r = 0; r < rows; ++r)
    out[(size_t)(row0 + r) * nb + col] = (float)hamming(sA[r], b);
}

__global__ void __launch_bounds__(M_THREADS)
masked_match_partial(const uint32_t* __restrict__ A, const float* __restrict__ uva, int na,
                     const uint32_t* __restrict__ B, const float* __restrict__ uvb,
                     const bool* __restrict__ valid_b, int nb, float r, int tiles_per_split,
                     unsigned* __restrict__ part1, unsigned* __restrict__ part2) {
  __shared__ uint32_t sB[M_TILE][WORDS];
  __shared__ float sU[M_TILE], sV[M_TILE];
  const int row = blockIdx.x * M_THREADS + threadIdx.x;
  uint32_t a[WORDS];
  float ua = 0.0f, va = 0.0f;
  if (row < na) {
#pragma unroll
    for (int w = 0; w < WORDS; ++w) a[w] = A[(size_t)row * WORDS + w];
    ua = uva[2 * row];
    va = uva[2 * row + 1];
  }
  unsigned k1 = NONE, k2 = NONE;
  const int n_tiles = (nb + M_TILE - 1) / M_TILE;
  const int t_end = min(n_tiles, (int)(blockIdx.y + 1) * tiles_per_split);
  const float nan = __int_as_float(0x7fc00000);
  for (int tile = blockIdx.y * tiles_per_split; tile < t_end; ++tile) {
    const int base = tile * M_TILE;
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < M_TILE; j += M_THREADS) {
      const int c = base + j;
      const bool ok = c < nb && valid_b[c];
      sU[j] = ok ? uvb[2 * c] : nan;
      sV[j] = ok ? uvb[2 * c + 1] : nan;
#pragma unroll
      for (int w = 0; w < WORDS; ++w) sB[j][w] = ok ? B[(size_t)c * WORDS + w] : 0u;
    }
    __syncthreads();
    if (row >= na) continue;
    for (int j = 0; j < M_TILE; ++j) {
      if (fabsf(ua - sU[j]) <= r && fabsf(va - sV[j]) <= r) {
        const unsigned key = ((unsigned)hamming(a, sB[j]) << COL_BITS) | (unsigned)(base + j);
        if (key < k1) {
          k2 = k1;
          k1 = key;
        } else if (key < k2) {
          k2 = key;
        }
      }
    }
  }
  if (row < na) {
    part1[(size_t)blockIdx.y * na + row] = k1;
    part2[(size_t)blockIdx.y * na + row] = k2;
  }
}

__device__ __forceinline__ float key_dist(unsigned k) {
  return k == NONE ? BIG : (float)(k >> COL_BITS);
}

__global__ void masked_match_finish(const unsigned* __restrict__ part1,
                                    const unsigned* __restrict__ part2, int splits, int na,
                                    float* best, float* second, int* idx) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= na) return;
  unsigned a1 = NONE, a2 = NONE;
  for (int s = 0; s < splits; ++s) {
    const unsigned b1 = part1[(size_t)s * na + row], b2 = part2[(size_t)s * na + row];
    const unsigned lo = min(a1, b1);
    a2 = min(max(a1, b1), min(a2, b2));
    a1 = lo;
  }
  best[row] = key_dist(a1);
  second[row] = key_dist(a2);
  idx[row] = a1 == NONE ? -1 : (int)(a1 & ((1u << COL_BITS) - 1));
}

}  // namespace

// A (na, 8), B (nb, 8) 32-bit words -> out (na, nb) f32.
extern "C" int hamming_matrix(const void* A, int na, const void* B, int nb, float* out,
                              void* stream) {
  if (na < 0 || nb < 0) return (int)cudaErrorInvalidValue;
  if (na == 0 || nb == 0) return 0;
  const dim3 grid((nb + H_THREADS - 1) / H_THREADS, (na + H_ROWS - 1) / H_ROWS);
  hamming_matrix_kernel<<<grid, H_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)A, na, (const uint32_t*)B, nb, out);
  return (int)cudaGetLastError();
}

// A (na, 8) words, uva (na, 2) f32; B (nb, 8), uvb (nb, 2) f32, valid_b (nb,)
// bool; part1/part2 (splits, na) uint32 scratch -> best, second (na,) f32 and
// idx (na,) int32 (-1 where no target passed the window).
extern "C" int masked_match(const void* A, const float* uva, int na, const void* B,
                            const float* uvb, const bool* valid_b, int nb, float radius,
                            int splits, unsigned* part1, unsigned* part2, float* best,
                            float* second, int* idx, void* stream) {
  if (na < 0 || nb < 0 || nb > (1 << COL_BITS) || splits < 1) return (int)cudaErrorInvalidValue;
  if (na == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (nb + M_TILE - 1) / M_TILE;
  const int per_split = n_tiles == 0 ? 1 : (n_tiles + splits - 1) / splits;
  const dim3 grid((na + M_THREADS - 1) / M_THREADS, splits);
  masked_match_partial<<<grid, M_THREADS, 0, st>>>((const uint32_t*)A, uva, na,
                                                   (const uint32_t*)B, uvb, valid_b, nb,
                                                   radius, per_split, part1, part2);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  masked_match_finish<<<(na + 127) / 128, 128, 0, st>>>(part1, part2, splits, na, best,
                                                          second, idx);
  return (int)cudaGetLastError();
}
