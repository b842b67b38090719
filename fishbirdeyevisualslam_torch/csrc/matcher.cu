// Fused projection matchers: one +/-1 bf16 descriptor contraction between a
// frame's keypoints (queries) and projected map points (targets), gated per
// pair by a square search window and an optional octave interval, reduced
// per query without the distance matrix ever reaching device memory.
//
// Replaces two TPU kernels of fishbirdeyevisualslam_tpu/ops/pallas_matcher.py:
//   * fused_projection_match (_proj_match_kernel): running best, second-best
//     and argmin, then max_dist and an optional ratio test
//                                            -> single_partial<LW, false>
//   * fused_projection_match_dual (_proj_match_kernel_dual): two gated top-1
//     reductions, window r and r * r2_scale, from one contraction
//                                            -> single_partial<LW, true>
// Their plain versions are the dense ops/matcher.py:match references in
// ops/cuda_matcher.py.
//
// What bounds them on an H100: operations.  2048 x 4096 pairs x 256 MACs is
// 4.3 GFLOP of bf16 per call against ~3.5 MB of operands, 4.3 us at the
// tensor-core peak; the gate and the reduction add ~15 integer/f32 ops per
// pair on the CUDA cores (~4 us at this width), so the epilogue must overlap
// the products and the loads.
//
// Both pack each (distance, column) pair into one 32-bit key
// (256 - dot) * 65536 + column, unique per column, so a plain min gives the
// distance and the LOWEST column among ties (the TPU kernel's packed
// d * 8192 + col min and strict t1 < b1 merge).  The single matcher keeps the
// two least keys (the second-best is the min over every other column and may
// equal the best); the dual keeps one least key per window.  The target axis
// is split over blockIdx.y; a second small kernel merges the per-split
// partial keys (exact, order-free) and applies max_dist and the ratio test.
// The TPU kernels' transposed aux layout, VMEM tile limits and tile_b <= 8192
// packing limit are gone; nb <= 65536 is the key's limit.
//
// The design, built for Hopper (single_partial):
//   * the gate reads the caller's tensors as they are (uv with its strides,
//     octave and predicted level as f32 / int32 / int64, the valid flags,
//     per-target radii or one radius by value): no preparation launches;
//   * a block owns 128 query rows, two consumer warpgroups of 64, whose
//     descriptors TMA loads once into shared memory (128-byte swizzle; rows
//     past na are zero-filled by TMA and masked by the gate);
//   * a producer warp streams 64-target tiles through a 3-stage ring of
//     shared buffers with mbarriers (full: TMA bytes + the tile's gate inputs
//     staged by the producer's lanes; empty: every consumer thread done), so
//     loads run ahead of the products;
//   * each warpgroup contracts its 64 rows with a tile by wgmma
//     m64n64k16 bf16 -> f32 (exact: |dot| <= 256), 16 instructions from
//     shared-memory descriptors, and gates and reduces the accumulator in
//     registers: a thread owns 2 rows x 16 columns of each tile and keeps two
//     running keys per row (best and second, or the dual's narrow and wide
//     top-1); the 4 lanes that share a row merge them at the end.  No dot
//     tile goes to shared memory.
// The dual's wide window is r * r2_scale, rounded to f32 as the plain
// version computes it; its narrow top-1 also requires |du|, |dv| <= r.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int DESC = 256;            // descriptor length
constexpr unsigned NONE = 0xFFFFFFFFu;
constexpr float BIG = 1e9f;

// merge two (best, second) key pairs; keys are unique per column
__device__ __forceinline__ void merge2(unsigned& a1, unsigned& a2, unsigned b1, unsigned b2) {
  const unsigned lo = min(a1, b1);
  a2 = min(max(a1, b1), min(a2, b2));
  a1 = lo;
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

// ---- the contraction on Hopper: TMA ring, wgmma, register epilogue ----

constexpr int BM = 128;                 // query rows per block
constexpr int BN = 64;                  // target columns per tile
constexpr int KC = 64;                  // bf16 per 128-byte swizzled row chunk
constexpr int NK = DESC / KC;           // chunks along the descriptor
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;          // two warpgroups
constexpr int THREADS = CONSUMERS + 32; // + the producer warp
constexpr int A_CHUNK = BM * 128;       // bytes of one chunk of the block's queries
constexpr int B_CHUNK = BN * 128;       // bytes of one chunk of a target tile
constexpr int B_STAGE = NK * B_CHUNK;
constexpr int A_BYTES = NK * A_CHUNK;
constexpr int OFF_B = A_BYTES;
constexpr int OFF_AUX = OFF_B + STAGES * B_STAGE;
constexpr int OFF_BAR = OFF_AUX + STAGES * BN * 16;
constexpr int SMEM = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack

// a number of the caller's octave / level tensors: f32, int32 or int64
enum NumType { NUM_F32 = 0, NUM_I32 = 1, NUM_I64 = 2 };

__device__ __forceinline__ float load_num(const void* p, int type, long long i) {
  if (type == NUM_I32) return (float)static_cast<const int*>(p)[i];
  if (type == NUM_I64) return (float)static_cast<const long long*>(p)[i];
  return static_cast<const float*>(p)[i];
}

// The gate's inputs as the caller holds them; strides in elements.
struct GateArgs {
  const float* uva; long long uva_s0, uva_s1;
  const void* octa; int octa_type; long long octa_s;
  const bool* va; long long va_s;
  const float* uvb; long long uvb_s0, uvb_s1;
  const float* rb; long long rb_s; float r_value;  // rb null: r_value for every target
  const void* predb; int predb_type; long long predb_s;
  const bool* vb; long long vb_s;
  int na, nb;
  float r2_scale;                                  // the dual's wide window: r * r2_scale
};

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

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// expect `bytes` more from asynchronous copies, without arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int inner, int row) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2, %3}], [%4];"
               :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(inner),
                  "r"(row), "r"(smem_u32(bar))
               : "memory");
}

// shared-memory matrix descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32)
         | ((uint64_t)1 << 62);
}

// D (64 x 64, f32) (+)= A (64 x 16) B (64 x 16)^T, both bf16 from shared memory
__device__ __forceinline__ void wgmma_64x64x16(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// keep the compiler from moving accumulator reads across the asynchronous MMA
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Partial keys of one split of the targets: (best, second) per query row,
// or with DUAL (narrow top-1, wide top-1).
template <bool LEVEL_WINDOW, bool DUAL>
__global__ void __launch_bounds__(THREADS, 1)
single_partial(const __grid_constant__ CUtensorMap mapA, const __grid_constant__ CUtensorMap mapB,
               GateArgs g, int tiles_per_split, unsigned* __restrict__ part1,
               unsigned* __restrict__ part2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sA = smem;
  uint8_t* sB = smem + OFF_B;
  float4* aux = reinterpret_cast<float4*>(smem + OFF_AUX);  // u, v, radius (-1: invalid), pred
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* a_full = empty + STAGES;

  const int n_tiles = (g.nb + BN - 1) / BN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_count = max(0, min(n_tiles, t_begin + tiles_per_split) - t_begin);
  const int row0 = blockIdx.x * BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);           // the producer's lanes (+ the TMA bytes)
      mbar_init(&empty[s], CONSUMERS);   // every consumer thread
    }
    mbar_init(a_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warp: the queries once, then the target tiles ----
    const int lane = threadIdx.x - CONSUMERS;
    if (lane == 0) {
      mbar_arrive_tx(a_full, A_BYTES);
      for (int k = 0; k < NK; ++k) tma_load(sA + k * A_CHUNK, &mapA, a_full, k * KC, row0);
    }
    for (int t = 0; t < t_count; ++t) {
      const int s = t % STAGES;
      const int c0 = (t_begin + t) * BN;
      // the tile's gate inputs, loaded before the wait so that their latency
      // overlaps it
      float4 a[BN / 32];
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int col = c0 + lane + 32 * i;
        a[i] = make_float4(0.f, 0.f, -1.f, 0.f);
        if (col < g.nb) {
          const float r = g.rb ? g.rb[col * g.rb_s] : g.r_value;
          a[i].x = g.uvb[col * g.uvb_s0];
          a[i].y = g.uvb[col * g.uvb_s0 + g.uvb_s1];
          a[i].z = g.vb[col * g.vb_s] ? r : -1.f;  // |du| <= -1 (or -r2_scale) never holds
          a[i].w = load_num(g.predb, g.predb_type, col * g.predb_s);
        }
      }
      mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], B_STAGE);
        for (int k = 0; k < NK; ++k)
          tma_load(sB + s * B_STAGE + k * B_CHUNK, &mapB, &full[s], k * KC, c0);
      }
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) aux[s * BN + lane + 32 * i] = a[i];
      mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows row0 + 64 wg .. + 63 ----
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // accumulator fragment of m64nNk16: d[4j + 2h + e] is row 16 warp + lane / 4 + 8 h,
  // column 8 j + 2 (lane % 4) + e
  // (a query row that is padding or invalid carries u = NaN: |NaN - u_b| <= r
  // never holds)
  float qu[2], qv[2], qo[2];
  int qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = row0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    const bool in = q < g.na;
    qrow[h] = q;
    qu[h] = in && g.va[q * g.va_s] ? g.uva[q * g.uva_s0] : __int_as_float(0x7fc00000);
    qv[h] = in ? g.uva[q * g.uva_s0 + g.uva_s1] : 0.f;
    qo[h] = in ? load_num(g.octa, g.octa_type, q * g.octa_s) : 0.f;
  }
  unsigned m1[2] = {NONE, NONE}, m2[2] = {NONE, NONE};

  mbar_wait(a_full, 0);
  const uint64_t da0 = sw128_desc(sA + wg * 64 * 128);
  float d[32] = {};
  for (int t = 0; t < t_count; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint64_t db0 = sw128_desc(sB + s * B_STAGE);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)  // 16 bf16 = 32 bytes = 2 descriptor units
        wgmma_64x64x16(d, da0 + (k * A_CHUNK + kk * 32) / 16,
                       db0 + (k * B_CHUNK + kk * 32) / 16, (k | kk) != 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(d);

    // key = (256 - dot) * 65536 + col = base - (bits of 1.5 * 2^23 + dot) * 65536
    // modulo 2^32, with base = 256 * 65536 + col
    const unsigned c0 = (unsigned)(t_begin + t) * BN + (256u << 16);
    const float4* a = aux + s * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * (lane % 4) + e;
        const float4 b = a[c];
        const float rw = DUAL ? b.z * g.r2_scale : b.z;  // the (wide) window
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float du = fabsf(qu[h] - b.x), dv = fabsf(qv[h] - b.y);
          bool pass = du <= rw && dv <= rw;
          if (LEVEL_WINDOW) {
            const float dl = qo[h] - b.w;
            pass = pass && ((dl >= -1.f && dl <= 1.f) || b.w < 0.f);
          }
          const unsigned bits = __float_as_uint(d[4 * j + 2 * h + e] + 12582912.0f);
          const unsigned key = c0 + (unsigned)c - (bits << 16);
          if (DUAL) {
            const bool narrow = pass && du <= b.z && dv <= b.z;
            m1[h] = min(m1[h], narrow ? key : NONE);
            m2[h] = min(m2[h], pass ? key : NONE);
          } else {
            const unsigned k = pass ? key : NONE;
            m2[h] = min(m2[h], max(m1[h], k));
            m1[h] = min(m1[h], k);
          }
        }
      }
    }
    mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const unsigned o1 = __shfl_xor_sync(0xffffffffu, m1[h], off);
      const unsigned o2 = __shfl_xor_sync(0xffffffffu, m2[h], off);
      if (DUAL) {
        m1[h] = min(m1[h], o1);
        m2[h] = min(m2[h], o2);
      } else {
        merge2(m1[h], m2[h], o1, o2);
      }
    }
    if (lane % 4 == 0 && qrow[h] < g.na) {
      part1[(size_t)blockIdx.y * g.na + qrow[h]] = m1[h];
      part2[(size_t)blockIdx.y * g.na + qrow[h]] = m2[h];
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once at run time (no link against it)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, 256) bf16 rows in boxes of 64 x box_rows, 128-byte swizzle, rows
// past the end read as zeros
bool desc_map(CUtensorMap* map, const void* base, int rows, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)DESC, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)DESC * 2};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool LW, bool DUAL>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(single_partial<LW, DUAL>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
}

// The partial kernel over (row blocks, splits), then the merge into the
// outputs (the second triple is written only when DUAL).
template <bool DUAL>
int run(const void* A, const void* B, const GateArgs& g, int level_window, float max_dist,
        int use_ratio, float ratio, int splits, unsigned* part1, unsigned* part2, int* idx1,
        float* dist1, bool* ok1, int* idx2, float* dist2, bool* ok2, cudaStream_t st) {
  if (g.na < 0 || g.nb < 0 || g.nb > 65536 || splits < 1) return (int)cudaErrorInvalidValue;
  if (g.na == 0) return 0;
  int used_splits = 0;
  if (g.nb > 0) {
    CUtensorMap mapA, mapB;
    if (!desc_map(&mapA, A, g.na, BM) || !desc_map(&mapB, B, g.nb, BN))
      return (int)cudaErrorInvalidValue;
    static bool smem_set = false;
    if (!smem_set) {
      cudaError_t e = allow_smem<false, DUAL>();
      if (e == cudaSuccess) e = allow_smem<true, DUAL>();
      if (e != cudaSuccess) return (int)e;
      smem_set = true;
    }
    const int n_tiles = (g.nb + BN - 1) / BN;
    const dim3 grid((g.na + BM - 1) / BM, splits);
    const int per_split = (n_tiles + splits - 1) / splits;
    if (level_window)
      single_partial<true, DUAL><<<grid, THREADS, SMEM, st>>>(mapA, mapB, g, per_split, part1,
                                                              part2);
    else
      single_partial<false, DUAL><<<grid, THREADS, SMEM, st>>>(mapA, mapB, g, per_split, part1,
                                                               part2);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    used_splits = splits;
  }
  proj_match_finish<DUAL><<<(g.na + 127) / 128, 128, 0, st>>>(
      part1, part2, used_splits, g.na, max_dist, use_ratio, ratio, idx1, dist1, ok1, idx2,
      dist2, ok2);
  return (int)cudaGetLastError();
}

}  // namespace

// The single matcher: A (na, 256) and B (nb, 256) bf16, rows 16-byte aligned;
// the gate's inputs as GateArgs takes them (strides in elements; rb null:
// r_value for every target; octa_type / predb_type a NumType); part1/part2
// (splits, na) uint32 scratch; outputs idx, dist, ok (na,).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it refuses.
extern "C" int proj_match_single(
    const void* A, const float* uva, long long uva_s0, long long uva_s1, const void* octa,
    int octa_type, long long octa_s, const bool* va, long long va_s, int na, const void* B,
    const float* uvb, long long uvb_s0, long long uvb_s1, const float* rb, long long rb_s,
    float r_value, const void* predb, int predb_type, long long predb_s, const bool* vb,
    long long vb_s, int nb, int level_window, float max_dist, int use_ratio, float ratio,
    int splits, unsigned* part1, unsigned* part2, int* idx, float* dist, bool* ok,
    void* stream) {
  const GateArgs g{uva, uva_s0, uva_s1, octa, octa_type, octa_s, va, va_s,
                   uvb, uvb_s0, uvb_s1, rb, rb_s, r_value, predb, predb_type, predb_s,
                   vb, vb_s, na, nb, 1.f};
  return run<false>(A, B, g, level_window, max_dist, use_ratio, ratio, splits, part1, part2,
                    idx, dist, ok, nullptr, nullptr, nullptr, (cudaStream_t)stream);
}

// The dual matcher: the single matcher's arguments without the ratio test,
// plus r2_scale (>= 1) and a second output triple: (idx1, dist1, ok1) the
// top-1 within r, (idx2, dist2, ok2) the top-1 within r * r2_scale.
extern "C" int proj_match_dual(
    const void* A, const float* uva, long long uva_s0, long long uva_s1, const void* octa,
    int octa_type, long long octa_s, const bool* va, long long va_s, int na, const void* B,
    const float* uvb, long long uvb_s0, long long uvb_s1, const float* rb, long long rb_s,
    float r_value, const void* predb, int predb_type, long long predb_s, const bool* vb,
    long long vb_s, int nb, int level_window, float max_dist, float r2_scale, int splits,
    unsigned* part1, unsigned* part2, int* idx1, float* dist1, bool* ok1, int* idx2,
    float* dist2, bool* ok2, void* stream) {
  if (!(r2_scale >= 1.f)) return (int)cudaErrorInvalidValue;
  const GateArgs g{uva, uva_s0, uva_s1, octa, octa_type, octa_s, va, va_s,
                   uvb, uvb_s0, uvb_s1, rb, rb_s, r_value, predb, predb_type, predb_s,
                   vb, vb_s, na, nb, r2_scale};
  return run<true>(A, B, g, level_window, max_dist, 0, 0.f, splits, part1, part2, idx1, dist1,
                   ok1, idx2, dist2, ok2, (cudaStream_t)stream);
}
