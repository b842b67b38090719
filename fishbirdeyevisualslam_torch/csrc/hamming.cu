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
// The matrix (hamming_matrix_kernel) is bound by bytes, its Na x Nb x 4 B
// output (134 MB at 2048 x 16384, 40 us at 3.35 TB/s); the 8 popcounts per
// entry run at 16 per clock per SM, which is of the same order.  A block owns
// 32 query rows (staged in shared memory) and 256 target columns, one per
// thread, whose 8 words stay in registers; each thread writes its column of
// the 32 rows, so a warp writes 128 consecutive bytes per row.
//
// The masked match.  The TPU kernel tests the window on every (query, target)
// pair: 33.5 M tests for ~390 k pairs that pass at 2048 x 16384, radius 50,
// over a 900 px square, so any dense design is bound by those tests (~6 ops
// a pair, 3.2 us on this card).  What the inputs need is one read of them and
// the popcounts of the pairs that pass (0.23 us, by bytes).  So the targets
// are binned by position, and a query tests only the targets of the 3 x 3
// cells around its own, ~480 of them (44% pass).  Two launches:
//   * mm_bin, one cluster of CLUSTER blocks, each with a share of the
//     targets (valid, no NaN coordinate) and of the queries: it counts them
//     into a table of G x G slots in shared memory and writes the table out;
//     after one cluster barrier every block reads all the tables back
//     (coalesced, from L2), scans them, and scatters its share into
//     slot-sorted 16-byte records (u, v, column or row).  Block 0 writes the
//     slots' and the work items' starts.  The barrier takes the place of a
//     grid-wide step between counting and scattering, so nothing is zeroed
//     before the launch: the kernel writes every word of scratch that is read
//     after it.  What bounds it is a chain of dependent steps on 16 SMs (read,
//     count, barrier, read back, scan, scatter), each a round trip to L2 or a
//     block barrier; the scattered records are one 16-byte store each, so
//     the scatter is short.
//   * mm_match, a persistent grid: a work item is a batch of up to QB
//     queries of one slot against a chunk of up to CH of the targets of the
//     slot's neighbourhood.  The block stages the chunk in shared memory
//     (records, then the words gathered by column), and each warp takes one
//     query: its lanes walk the chunk, and for each target in the window
//     popcount the 8 XORed words and keep a top-2 of keys, merged across the
//     warp by two __reduce_min_sync.  A slot whose neighbourhood fits one
//     chunk writes its outputs at once; a slot with more chunks merges them
//     by atomicMin into per-query keys, and the block that finishes the
//     slot's last item writes its outputs (a counter per slot), so no third
//     launch merges anything.  What bounds it: four dependent reads from L2
//     before the first test (the items' starts, the slot's ranges, the
//     chunk's records, their words), then the popcounts (16 per clock per
//     SM) and shared-memory loads of the ~480 targets each query tests, all
//     of a warp's lanes popcounting once one of them passes.
// Cells: coordinate u lies in cell floor(u / s), s = max(r (1 + 1/32), 1 px)
// chosen by the wrapper, clamped to [-CELL_MAX, CELL_MAX] (positions first
// to +-POS_MAX, and NaN to the lowest cell).  Every step is monotone in u and
// the f32 rounding moves the cell coordinate by less than 2^-8, so a pair
// with |du| <= r lies in neighbouring cells; slot = cell mod G on each axis
// (G >= 4), so the nine slots of a neighbourhood are distinct and no target
// is read twice.  r = inf makes 1/s = 0: one cell, a dense scan spread over
// the chunks.  The window test itself is the plain version's f32 test, so a
// NaN radius or position passes nothing, as there.
// Each (distance, column) pair is one 32-bit key d << 20 | column, unique per
// column: the least key is the least distance at the LOWEST column, and the
// second-best is the least key over every other column (it may equal the
// best distance), whatever order the targets were binned or merged in.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WORDS = 8;
constexpr int H_THREADS = 256;  // target columns per matrix block
constexpr int H_ROWS = 32;      // query rows per matrix block
constexpr int COL_BITS = 20;
constexpr unsigned NONE = 0xFFFFFFFFu;
constexpr float BIG = 1e9f;

constexpr int CLUSTER = 16;           // blocks of the binning cluster (above the portable 8)
constexpr int BIN_THREADS = 1024;     // threads of a binning block
constexpr int MATCH_THREADS = 256;    // threads of a match block: one warp per query
constexpr int QB = MATCH_THREADS / 32;  // queries of one work item
constexpr int CH = 768;               // targets of one work item
constexpr int MAX_LG = 6;             // at most 64 x 64 slots
constexpr float CELL_MAX = 32768.0f;  // cell coordinates clamped to [-CELL_MAX, CELL_MAX]
constexpr float POS_MAX = 1e30f;      // positions clamped first, so inf * (1/s = 0) is 0

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

// ---- the masked match ------------------------------------------------------

// floor(u / s) from the wrapper's f32 1/s, clamped; NaN goes to -CELL_MAX.
__device__ __forceinline__ int cell(float u, float inv_s) {
  const float x = fminf(fmaxf(u, -POS_MAX), POS_MAX);
  return __float2int_rd(fminf(fmaxf(x * inv_s, -CELL_MAX), CELL_MAX));
}

__device__ __forceinline__ int slot_of(float u, float v, float inv_s, int lg) {
  const int m = (1 << lg) - 1;
  return (cell(u, inv_s) & m) | ((cell(v, inv_s) & m) << lg);
}

__device__ __forceinline__ bool binned(bool valid, float u, float v) {
  return valid && u == u && v == v;  // a NaN coordinate passes no window
}

// The i-th slot of slot s's 3 x 3 neighbourhood (i = 0..8).
__device__ __forceinline__ int neighbour(int s, int i, int lg) {
  const int m = (1 << lg) - 1;
  return ((s + i % 3 - 1) & m) | ((((s >> lg) + i / 3 - 1) & m) << lg);
}

struct BinArgs {
  const uint32_t* A;
  const float* uva;
  int na;
  const uint32_t* B;
  const float* uvb;
  const bool* valid_b;
  int nb;
  float inv_s;
  int lg;
  int* counts;   // (2, CLUSTER, S): each block's counts of targets, then of queries
  int* tstart;   // (S + 1,) targets' slot starts
  int* qstart;   // (S + 1,) queries' slot starts
  int* istart;   // (S + 1,) work items' slot starts
  int* done;     // (S,) items finished, per slot
  uint4* trec;   // (nb,) slot-sorted targets: (u, v, column, 0)
  uint4* qrec;   // (na,) slot-sorted queries: (u, v, row, 0)
  unsigned* acc1;  // (na,) best and second key of a query, by sorted position
  unsigned* acc2;
};

// The first step of an exclusive scan over the block of one value per
// thread: returns its prefix within the warp and leaves the warp's total in
// wsum[warp].  scan_warps then turns wsum[] into the warps' prefixes and the
// total (wsum[32]).
__device__ __forceinline__ int scan_step(int own, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  return inc - own;
}

__device__ __forceinline__ void scan_warps(int* wsum) {
  const int lane = threadIdx.x & 31;
  const int w = lane < BIN_THREADS / 32 ? wsum[lane] : 0;
  int wi = w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, wi, o);
    if (lane >= o) wi += y;
  }
  if (lane < BIN_THREADS / 32) wsum[lane] = wi - w;
  if (lane == 31) wsum[32] = wi;
}

// One cluster bins every target and query: each block counts its share into
// a table in its shared memory and writes the table out; after one cluster
// barrier every block reads all the tables back (coalesced, from L2), scans
// them, and scatters its share into slot-sorted records.  Block 0 writes the
// slots' and the work items' starts.
__global__ void __launch_bounds__(BIN_THREADS) mm_bin(const __grid_constant__ BinArgs a) {
  extern __shared__ int sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5;
  const int S = 1 << (2 * a.lg);
  int* cntT = sm;  // (S,) this block's counts, then the cluster's
  int* cntQ = cntT + S;
  int* items = cntQ + S;  // (S,) work items per slot
  int* offT = items + S;  // (S,) this block's next scatter position per slot
  int* offQ = offT + S;
  int* wsum = offQ + S;  // 3 x 33
  const int tper = (a.nb + CLUSTER - 1) / CLUSTER;
  const int t0 = min(a.nb, rank * tper), t1 = min(a.nb, t0 + tper);
  const int qper = (a.na + CLUSTER - 1) / CLUSTER;
  const int q0 = min(a.na, rank * qper), q1 = min(a.na, q0 + qper);

  for (int s = tid; s < S; s += BIN_THREADS) cntT[s] = cntQ[s] = 0;
  for (int i = q0 + tid; i < q1; i += BIN_THREADS) a.acc1[i] = a.acc2[i] = NONE;
  for (int s = rank * BIN_THREADS + tid; s < S; s += CLUSTER * BIN_THREADS) a.done[s] = 0;
  __syncthreads();
  const int n_loop = max(t1 - t0, q1 - q0);  // a target and a query per thread and turn
  for (int k = tid; k < n_loop; k += BIN_THREADS) {
    const int j = t0 + k, i = q0 + k;
    if (j < t1) {
      const float u = a.uvb[2 * j], v = a.uvb[2 * j + 1];
      if (binned(a.valid_b[j], u, v)) atomicAdd(&cntT[slot_of(u, v, a.inv_s, a.lg)], 1);
    }
    if (i < q1) atomicAdd(&cntQ[slot_of(a.uva[2 * i], a.uva[2 * i + 1], a.inv_s, a.lg)], 1);
  }
  __syncthreads();
  for (int s = tid; s < S; s += BIN_THREADS) {
    a.counts[rank * S + s] = cntT[s];
    a.counts[(CLUSTER + rank) * S + s] = cntQ[s];
  }
  cluster.sync();  // every block's table is out (the barrier orders global memory too)

  for (int s = tid; s < S; s += BIN_THREADS) {
    int tt = 0, pt = 0, tq = 0, pq = 0;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {
      const int ct = __ldcg(&a.counts[r * S + s]), cq = __ldcg(&a.counts[(CLUSTER + r) * S + s]);
      tt += ct;
      tq += cq;
      if (r < rank) {
        pt += ct;
        pq += cq;
      }
    }
    cntT[s] = tt;
    cntQ[s] = tq;
    offT[s] = pt;
    offQ[s] = pq;
  }
  __syncthreads();
  for (int s = tid; s < S; s += BIN_THREADS) {
    int nc = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) nc += cntT[neighbour(s, i, a.lg)];
    const int nq = cntQ[s];
    items[s] = nq == 0 ? 0 : (nq + QB - 1) / QB * max(1, (nc + CH - 1) / CH);
  }
  __syncthreads();
  // exclusive scans of the three tables over the slots, each thread owning a
  // run of `per` consecutive slots
  const int per = (S + BIN_THREADS - 1) / BIN_THREADS;
  const int s0 = min(S, tid * per), s1 = min(S, s0 + per);
  int ownT = 0, ownQ = 0, ownI = 0;
  for (int s = s0; s < s1; ++s) {
    ownT += cntT[s];
    ownQ += cntQ[s];
    ownI += items[s];
  }
  int runT = scan_step(ownT, wsum);
  int runQ = scan_step(ownQ, wsum + 33);
  int runI = scan_step(ownI, wsum + 66);
  __syncthreads();
  for (int k = warp; k < 3; k += BIN_THREADS / 32) scan_warps(wsum + 33 * k);
  __syncthreads();
  runT += wsum[warp];
  runQ += wsum[33 + warp];
  runI += wsum[66 + warp];
  const bool lead = rank == 0;
  for (int s = s0; s < s1; ++s) {
    offT[s] += runT;
    offQ[s] += runQ;
    if (lead) {
      a.tstart[s] = runT;
      a.qstart[s] = runQ;
      a.istart[s] = runI;
    }
    runT += cntT[s];
    runQ += cntQ[s];
    runI += items[s];
  }
  if (lead && tid == 0) {
    a.tstart[S] = wsum[32];
    a.qstart[S] = wsum[33 + 32];
    a.istart[S] = wsum[66 + 32];
  }
  __syncthreads();  // every offset is in place before any thread scatters

  for (int k = tid; k < n_loop; k += BIN_THREADS) {
    const int j = t0 + k, i = q0 + k;
    if (j < t1) {
      const float u = a.uvb[2 * j], v = a.uvb[2 * j + 1];
      if (binned(a.valid_b[j], u, v)) {
        const int p = atomicAdd(&offT[slot_of(u, v, a.inv_s, a.lg)], 1);
        a.trec[p] = make_uint4(__float_as_uint(u), __float_as_uint(v), (unsigned)j, 0u);
      }
    }
    if (i < q1) {
      const float u = a.uva[2 * i], v = a.uva[2 * i + 1];
      const int p = atomicAdd(&offQ[slot_of(u, v, a.inv_s, a.lg)], 1);
      a.qrec[p] = make_uint4(__float_as_uint(u), __float_as_uint(v), (unsigned)i, 0u);
    }
  }
}

struct MatchArgs {
  float r;
  int lg;
  const uint4* A;  // (na, 2) and (nb, 2) uint4: the descriptor words
  const uint4* B;
  const int* tstart;
  const int* qstart;
  const int* istart;
  int* done;
  const uint4* trec;
  const uint4* qrec;
  unsigned* acc1;
  unsigned* acc2;
  float* best;
  float* second;
  int* idx;
};

__device__ __forceinline__ void write_out(const MatchArgs& a, int row, unsigned k1,
                                          unsigned k2) {
  a.best[row] = k1 == NONE ? BIG : (float)(k1 >> COL_BITS);
  a.second[row] = k2 == NONE ? BIG : (float)(k2 >> COL_BITS);
  a.idx[row] = k1 == NONE ? -1 : (int)(k1 & ((1u << COL_BITS) - 1));
}

__global__ void __launch_bounds__(MATCH_THREADS) mm_match(const __grid_constant__ MatchArgs a) {
  extern __shared__ int s_items[];  // (S + 1,) work items' slot starts
  __shared__ float2 sUV[CH];
  __shared__ int sCol[CH];
  __shared__ uint4 sW[2][CH];
  __shared__ uint4 sQrec[QB], sQw[QB][2];
  __shared__ int sRs[9], sRn[9], sQ[2], sLast;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = 1 << (2 * a.lg);
  for (int k = tid; k <= S; k += MATCH_THREADS) s_items[k] = a.istart[k];
  __syncthreads();
  const int n_items = s_items[S];
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    int lo = 0, hi = S - 1;  // the last slot whose first item is <= item
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_items[mid] <= item) lo = mid; else hi = mid - 1;
    }
    const int s = lo;
    if (tid < 9) {
      const int n = neighbour(s, tid, a.lg);
      const int b = a.tstart[n];
      sRs[tid] = b;
      sRn[tid] = a.tstart[n + 1] - b;
    } else if (tid < 11) {
      sQ[tid - 9] = a.qstart[s + tid - 9];
    }
    __syncthreads();
    int nc = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) nc += sRn[i];
    const int n_chunks = max(1, (nc + CH - 1) / CH);
    const int l = item - s_items[s];
    const int batch = l / n_chunks, chunk = l - batch * n_chunks;
    const int q0 = sQ[0] + batch * QB, nq = min(QB, sQ[1] - q0);
    const int c0 = chunk * CH, cn = min(CH, nc - c0);
    if (tid < nq) {
      const uint4 rec = a.qrec[q0 + tid];
      sQrec[tid] = rec;
      sQw[tid][0] = a.A[2 * rec.z];
      sQw[tid][1] = a.A[2 * rec.z + 1];
    }
    for (int j = tid; j < cn; j += MATCH_THREADS) {
      int g = c0 + j, k = 0;
      while (g >= sRn[k]) g -= sRn[k++];
      const uint4 rec = a.trec[sRs[k] + g];
      sUV[j] = make_float2(__uint_as_float(rec.x), __uint_as_float(rec.y));
      sCol[j] = (int)rec.z;
      sW[0][j] = a.B[2 * rec.z];
      sW[1][j] = a.B[2 * rec.z + 1];
    }
    __syncthreads();
    if (warp < nq) {  // a warp per query, its lanes over the chunk
      const uint4 qr = sQrec[warp];
      const float qu = __uint_as_float(qr.x), qv = __uint_as_float(qr.y);
      const uint4 x0 = sQw[warp][0], x1 = sQw[warp][1];
      unsigned k1 = NONE, k2 = NONE;
      for (int j = lane; j < cn; j += 32) {
        const float2 t = sUV[j];
        if (fabsf(qu - t.x) <= a.r && fabsf(qv - t.y) <= a.r) {
          const uint4 y0 = sW[0][j], y1 = sW[1][j];
          const int d = __popc(x0.x ^ y0.x) + __popc(x0.y ^ y0.y) + __popc(x0.z ^ y0.z) +
                        __popc(x0.w ^ y0.w) + __popc(x1.x ^ y1.x) + __popc(x1.y ^ y1.y) +
                        __popc(x1.z ^ y1.z) + __popc(x1.w ^ y1.w);
          const unsigned key = ((unsigned)d << COL_BITS) | (unsigned)sCol[j];
          k2 = min(k2, max(k1, key));
          k1 = min(k1, key);
        }
      }
      // the warp's top-2: its least key, then the least of the other lanes'
      // bests and the best lane's second (keys are unique)
      const unsigned w1 = __reduce_min_sync(0xffffffffu, k1);
      const unsigned w2 = __reduce_min_sync(0xffffffffu, k1 == w1 ? k2 : k1);
      if (lane == 0) {
        if (n_chunks == 1) {
          write_out(a, (int)qr.z, w1, w2);
        } else {
          const unsigned old = atomicMin(&a.acc1[q0 + warp], w1);
          atomicMin(&a.acc2[q0 + warp], min(max(old, w1), w2));
          __threadfence();
        }
      }
    }
    if (n_chunks > 1) {  // the block that finishes the slot's last item writes its queries
      __syncthreads();
      if (tid == 0) sLast = atomicAdd(&a.done[s], 1) == s_items[s + 1] - s_items[s] - 1;
      __syncthreads();
      if (sLast) {
        __threadfence();
        for (int p = sQ[0] + tid; p < sQ[1]; p += MATCH_THREADS)
          write_out(a, (int)a.qrec[p].z, __ldcg(&a.acc1[p]), __ldcg(&a.acc2[p]));
      }
    }
    __syncthreads();  // the shared arrays are staged again for the next item
  }
}

// Scratch of the masked match, each array 256-byte aligned.
struct Layout {
  size_t counts, tstart, qstart, istart, done, trec, qrec, acc1, acc2, bytes;
};

Layout layout(int na, int nb, int lg) {
  const size_t S = (size_t)1 << (2 * lg);
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += (bytes + 255) & ~(size_t)255;
    return at;
  };
  Layout l;
  l.counts = take(2 * CLUSTER * S * 4);
  l.tstart = take((S + 1) * 4);
  l.qstart = take((S + 1) * 4);
  l.istart = take((S + 1) * 4);
  l.done = take(S * 4);
  l.trec = take((size_t)nb * 16);
  l.qrec = take((size_t)na * 16);
  l.acc1 = take((size_t)na * 4);
  l.acc2 = take((size_t)na * 4);
  l.bytes = off;
  return l;
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

// Bytes of scratch that masked_match needs for na queries, nb targets and a
// table of 4^lg slots.
extern "C" size_t masked_match_scratch(int na, int nb, int lg) {
  return layout(na < 0 ? 0 : na, nb < 0 ? 0 : nb, lg).bytes;
}

// A (na, 8) words, uva (na, 2) f32; B (nb, 8), uvb (nb, 2) f32, valid_b (nb,)
// bool (A and B 16-byte aligned); the window radius, the cells' f32 1/s and
// log2 of the table side; scratch of masked_match_scratch(na, nb, lg) bytes
// -> best, second (na,) f32 and idx (na,) int32 (-1 where no target passed
// the window).  Two launches on the stream, no host synchronisation.
extern "C" int masked_match(const void* A, const float* uva, int na, const void* B,
                            const float* uvb, const bool* valid_b, int nb, float radius,
                            float inv_cell, int lg, void* scratch, size_t scratch_bytes,
                            float* best, float* second, int* idx, void* stream) {
  if (na < 0 || nb < 0 || nb > (1 << COL_BITS) || lg < 2 || lg > MAX_LG)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(na, nb, lg);
  if (scratch_bytes < l.bytes) return (int)cudaErrorInvalidValue;
  if (na == 0) return 0;
  char* base = (char*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  const int S = 1 << (2 * lg);

  BinArgs b;
  b.A = (const uint32_t*)A;
  b.uva = uva;
  b.na = na;
  b.B = (const uint32_t*)B;
  b.uvb = uvb;
  b.valid_b = valid_b;
  b.nb = nb;
  b.inv_s = inv_cell;
  b.lg = lg;
  b.counts = (int*)(base + l.counts);
  b.tstart = (int*)(base + l.tstart);
  b.qstart = (int*)(base + l.qstart);
  b.istart = (int*)(base + l.istart);
  b.done = (int*)(base + l.done);
  b.trec = (uint4*)(base + l.trec);
  b.qrec = (uint4*)(base + l.qrec);
  b.acc1 = (unsigned*)(base + l.acc1);
  b.acc2 = (unsigned*)(base + l.acc2);
  const int bin_smem = (5 * S + 3 * 33) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(mm_bin, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bin_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mm_bin, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, 1, 1);
  cfg.blockDim = dim3(BIN_THREADS, 1, 1);
  cfg.dynamicSmemBytes = bin_smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mm_bin, b);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  MatchArgs m;
  m.r = radius;
  m.lg = lg;
  m.tstart = b.tstart;
  m.qstart = b.qstart;
  m.istart = b.istart;
  m.done = b.done;
  m.A = (const uint4*)A;
  m.B = (const uint4*)B;
  m.trec = b.trec;
  m.qrec = b.qrec;
  m.acc1 = b.acc1;
  m.acc2 = b.acc2;
  m.best = best;
  m.second = second;
  m.idx = idx;
  const int match_smem = (S + 1) * (int)sizeof(int);
  err = cudaFuncSetAttribute(mm_match, cudaFuncAttributeMaxDynamicSharedMemorySize, match_smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mm_match, MATCH_THREADS,
                                                           match_smem)) != cudaSuccess)
    return (int)err;
  const int grid = sms * (per_sm > 0 ? per_sm : 1);  // persistent: all blocks resident
  mm_match<<<grid, MATCH_THREADS, match_smem, st>>>(m);
  return (int)cudaGetLastError();
}
