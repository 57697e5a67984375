// Sliding-window GQA decode attention for one new token, for sm_90a.
//
//   out[b, h, g, :] = sum_j p[g, j] * v_cache[b, j, h, :],  j in [lo, hi)
//   p[g, :] = softmax_j(q[b, h, g, :] . k_cache[b, j, h, :] * scale)
//   lo = max(0, pos[b] - window),  hi = min(pos[b], S),  scale = 1/sqrt(D)
//
// Replaces the Pallas kernel repro/kernels/swa_attention.py::_swa_kernel
// together with what its wrapper repro/kernels/ops.py::swa_attention_decode
// does around it.  The wrapper copies an aligned (window + 8)-row slice of
// the cache into VMEM and the kernel masks it to [lo, hi); here the kernel
// reads exactly the rows [lo, hi) straight from the (B, S, KVH, D) cache, so
// there is no copy and no padding of D or of the window.
//
// Bound: memory.  Per position the kernel reads one K row and one V row
// (2 * D * sizeof(T) bytes) and do 4 * G * D float32 operations, so G
// operations per byte in bf16 (4 at G = 4), far below the card's ridge.
// At the serve shape (B = 4, KVH = 8, G = 4, D = 80, window 4096) that is
// ~42 MB of K and V, 12.5 us at the card's byte rate.  A first version (one
// block per (row, kv head), three passes over the window in shared memory)
// ran 32 blocks on 132 SMs at that shape, kept one load per thread in
// flight and did its arithmetic on the CUDA cores behind block-wide
// barriers; it reached 6% of the bound.
//
// Design (split softmax, "flash-decoding", with a fixed-order combine): the
// wrapper cuts every row's window into `splits` chunks of `chunk` positions
// (a plan fixed by the shape and the card's SM count), so the serve shape
// runs 32 rows x 16 splits = 512 blocks.  The grid is (B * KVH, splits); a
// block computes, for each of its G query rows, the chunk's max m, the sum
// l = sum exp(s - m) and the unnormalised o = sum exp(s - m) v in float32,
// and writes them to a float32 scratch (B, KVH, splits, G, D + 2) that the
// wrapper allocates; a chunk past a row's window (ragged pos) writes
// m = -inf, l = 0, o = 0.  The last block of a row to finish (an integer
// atomic counter per row, which that block resets to zero) merges the
// row's splits: M = max_i m_i, w_i = exp(m_i - M) (0 where m_i = -inf, so
// an empty window gives exact zeros, not NaN), den = sum_i l_i w_i and
// out = (sum_i o_i w_i) / max(den, 1e-30), the splits taken in split order
// whichever block comes last, rounded once to q's type.  K and V are read
// with 16-byte cp.async copies into rings of shared memory, several copies
// per thread in flight.  Two kernels do the per-block work:
//   swa_split_mma_kernel  bf16 at D = 64, 80 or 128 (the LM path): four warps,
//      each streaming its own tiles of 16 positions (K and V together)
//      through its own two-stage ring, with no block-wide barrier between a
//      tile's arrival and its use, and an online softmax (running max and
//      sum, P.V rescaled when the max grows).  Both products run on the
//      tensor cores (mma.sync m16n8k16, float32 accumulators), transposed so
//      that the G query rows are the 8 (or 16) columns of the B fragment:
//        S^T = K q^T     K (bf16) times q (bf16): the products are exact in
//                        float32;
//        O^T += V^T P^T  p is float32, so it is split into three bf16 parts,
//                        p = hi + mid + lo exactly (8 + 8 + 8 significant
//                        bits), and each part times V (bf16) is again exact.
//      The four warps' (m, l, o) are merged in warp order.
//   swa_split_kernel  every other shape (float32, other D) on the CUDA
//      cores: 256 threads stream the chunk's K tiles, then its V tiles, of
//      64 positions through a two-stage ring; scores by four lanes per
//      position with a fixed butterfly, kept for the chunk in shared memory
//      (G * chunk float32) for a two-pass softmax; P.V with one 16-byte
//      column of V for up to kAccFloats / vector-width query rows and a
//      residue class of positions per thread, the classes added in order.
// Numerics are therefore a split softmax, not the Pallas kernel's single
// pass: float32 sums of exact products throughout (on the tensor cores in
// their own fixed order), with float32 rounding differences only.  There
// are no float atomics, so two launches on the same inputs give
// bit-identical output.  Offsets into the cache are 64-bit.  A shape whose
// ring does not fit in a block's shared memory (float32 rows of several
// hundred elements), or whose CUDA-core P.V columns outnumber the block's
// threads, is refused, never rerouted.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;                   // CUDA-core kernel
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerPos = 4;                 // CUDA-core scores: lanes per position
constexpr int kTile = kThreads / kLanesPerPos;  // positions per ring stage
constexpr int kStages = 2;  // more stages leave fewer blocks resident: slower on the H100
constexpr int kMaxGroups = 16;
constexpr int kAccFloats = 32;  // CUDA-core P.V accumulators a thread keeps in registers
constexpr int kMmaWarps = 4;    // tensor-core kernel: warps, each with its own ring
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaTile = 16;    // positions per warp tile: one k-step of P.V
constexpr int kMmaStages = 2;   // more stages or warps per block measured no faster on the H100
constexpr float kSumFloor = 1e-30f;

constexpr int kErrSharedMemory = -1;
constexpr int kErrShape = -2;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;  // elements per 16 bytes
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  __device__ static void unpack(const uint4 v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_float(float x) { return __float2bfloat16_rn(x); }
  __device__ static void unpack(const uint4 v, float* out) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little endian: the lower address is the low half
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// A 16-byte copy to shared memory that bypasses L1.  The L2 fetches the
// whole 128-byte line: a row of one head is 160 bytes of a 1280-byte cache
// row, and the blocks of the neighbouring heads read the rest of the line
// at about the same time (measured faster than no hint on the H100).
__device__ __forceinline__ void cp_async16(void* dst_smem, const void* src_gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src_gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// c += a (16 x 16) * b (16 x 8), bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (16 x 16 bf16) from four 8 x 8 matrices of shared memory;
// lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* a, const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Query rows a CUDA-core P.V thread accumulates: kAccFloats floats.
template <typename T, int kG>
__host__ __device__ constexpr int pv_rows() {
  return kG * Io<T>::kVec <= kAccFloats ? kG : kAccFloats / Io<T>::kVec;
}

// Row strides in shared memory, in 4-byte words.  The CUDA-core kernel
// reads 16 bytes of 2 rows per quarter warp, which hit distinct banks when
// the stride is 16 mod 32 words; the tensor-core kernel reads 4 bytes (or
// ldmatrix rows of 16 bytes) of 8 rows at once, which needs 4 mod 8.
__host__ __device__ constexpr int cuda_core_words(int words) {
  return words + (48 - words % 32) % 32;
}
__host__ __device__ constexpr int mma_words(int words) {
  return words + (words % 8 == 4 ? 0 : (12 - words % 8) % 8);
}

// The CUDA-core kernel's dynamic shared memory: float32 q [G][D], float32
// scores [G][chunk] (then exp(s - m)), and the ring, which afterwards takes
// the P.V partials [pgroups][G][D].
__host__ __device__ inline int smem_bytes(int groups, int d, int chunk, int stride, int pgroups) {
  const int ring = kStages * kTile * stride;
  const int part = pgroups * groups * d * 4;
  return groups * d * 4 + groups * chunk * 4 + (ring > part ? ring : part);
}

// CUDA cores, any D that is a multiple of 16 bytes.  kG: the most query
// heads per kv head the instantiation holds (4 or 16).
template <typename T, int kG>
__device__ __forceinline__ void split_cuda_cores(const T* __restrict__ q,
                                                 const T* __restrict__ k_cache,
                                                 const T* __restrict__ v_cache,
                                                 const int32_t* __restrict__ pos,
                                                 float* __restrict__ partial, int kvh, int groups,
                                                 int d, long long seq, long long window,
                                                 int chunk, int splits, int stride, int pgroups,
                                                 float scale) {
  constexpr int kE = Io<T>::kVec;
  constexpr int kGA = pv_rows<T, kG>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float ml_s[2 * kMaxGroups];  // m and l of each query row
  float* q_s = reinterpret_cast<float*>(smem);  // [groups][d]
  float* s_s = q_s + groups * d;                // [groups][chunk]
  unsigned char* ring = reinterpret_cast<unsigned char*>(s_s + groups * chunk);
  float* part_s = reinterpret_cast<float*>(ring);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int vpr = d / kE;  // 16-byte vectors per row
  const long long row = blockIdx.x;  // b * kvh + h
  const int split = blockIdx.y;
  const T* qb = q + row * groups * d;
  for (int i = tid; i < groups * d; i += kThreads) q_s[i] = Io<T>::to_float(qb[i]);

  const long long b = row / kvh;
  const int h = static_cast<int>(row % kvh);
  const long long p = pos[b];
  const long long lo = p - window > 0 ? p - window : 0;
  const long long hi = p < seq ? p : seq;
  const long long c_lo = lo + static_cast<long long>(split) * chunk;
  const long long left = hi - c_lo;
  const int n = left <= 0 ? 0 : (left < chunk ? static_cast<int>(left) : chunk);
  float* out = partial + (row * splits + split) * groups * (d + 2);
  if (n == 0) {  // uniform over the block: a chunk past the window
    for (int i = tid; i < groups * (d + 2); i += kThreads)
      out[i] = i % (d + 2) == d ? -INFINITY : 0.0f;
    return;
  }

  const long long row_elems = static_cast<long long>(kvh) * d;
  const long long base = (b * seq + c_lo) * row_elems + static_cast<long long>(h) * d;
  const T* kb = k_cache + base;
  const T* vb = v_cache + base;
  const int ntiles = (n + kTile - 1) / kTile;
  const int total = 2 * ntiles;  // K tiles, then V tiles

  // this thread's copies of a tile: vectors tid, tid + kThreads, ... of the
  // (row, 16-byte column) grid, stepped without a division per copy
  const int r0 = tid / vpr;
  const int c0 = tid - r0 * vpr;
  const int dr = kThreads / vpr;
  const int dc = kThreads - dr * vpr;
  auto issue = [=](int t) {
    const bool is_k = t < ntiles;
    const int tile = is_k ? t : t - ntiles;
    const T* src = (is_k ? kb : vb) + static_cast<long long>(tile) * kTile * row_elems;
    const int rows = min(kTile, n - tile * kTile);
    unsigned char* dst = ring + (t % kStages) * kTile * stride;
    for (int r = r0, c = c0; r < rows;) {
      cp_async16(dst + r * stride + c * 16, src + r * row_elems + c * kE);
      r += dr;
      c += dc;
      if (c >= vpr) {
        c -= vpr;
        ++r;
      }
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < total) issue(t);
    cp_async_commit();
  }

  // P.V layout: item = (column, query-row group), pg = residue class of positions
  const int ggroups = (groups + kGA - 1) / kGA;
  const int items = vpr * ggroups;
  const int item = tid % items;
  const int pg = tid / items;
  const int col = item % vpr;
  const int g0 = (item / vpr) * kGA;
  float acc[kGA][kE];
#pragma unroll
  for (int a = 0; a < kGA; ++a)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[a][e] = 0.0f;

  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t has landed for every thread; slot (t - 1) is free
    if (t + kStages - 1 < total) issue(t + kStages - 1);
    cp_async_commit();
    const unsigned char* tile_s = ring + (t % kStages) * kTile * stride;
    if (t < ntiles) {
      // scores: lanes 4j..4j+3 take position j of the tile
      const int j = tid / kLanesPerPos;
      const int sub = tid % kLanesPerPos;
      const int jj = t * kTile + j;
      float a[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) a[g] = 0.0f;
      if (jj < n) {
        for (int v = sub; v < vpr; v += kLanesPerPos) {
          float x[kE];
          Io<T>::unpack(*reinterpret_cast<const uint4*>(tile_s + j * stride + v * 16), x);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g < groups) {
              const float4* qg = reinterpret_cast<const float4*>(q_s + g * d + v * kE);
              float s = a[g];
#pragma unroll
              for (int e = 0; e < kE; e += 4) {
                const float4 qq = qg[e / 4];
                s = fmaf(qq.x, x[e], s);
                s = fmaf(qq.y, x[e + 1], s);
                s = fmaf(qq.z, x[e + 2], s);
                s = fmaf(qq.w, x[e + 3], s);
              }
              a[g] = s;
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        a[g] += __shfl_xor_sync(0xffffffffu, a[g], 1);
        a[g] += __shfl_xor_sync(0xffffffffu, a[g], 2);
      }
      if (jj < n && sub == 0) {
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (g < groups) s_s[g * chunk + jj] = a[g] * scale;
      }
      continue;
    }
    if (t == ntiles) {
      // every score of the chunk is written: one warp per query row
      for (int g = warp; g < groups; g += kWarps) {
        float* sg = s_s + g * chunk;
        float m = -INFINITY;
        for (int j = lane; j < n; j += 32) m = fmaxf(m, sg[j]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        float l = 0.0f;
        for (int j = lane; j < n; j += 32) {
          const float e = expf(sg[j] - m);
          sg[j] = e;
          l += e;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
        if (lane == 0) {
          ml_s[2 * g] = m;
          ml_s[2 * g + 1] = l;
        }
      }
      __syncthreads();
    }
    const int tile = t - ntiles;
    const int rows = min(kTile, n - tile * kTile);
    if (pg < pgroups) {
      for (int j = pg; j < rows; j += pgroups) {
        float x[kE];
        Io<T>::unpack(*reinterpret_cast<const uint4*>(tile_s + j * stride + col * 16), x);
        const int jj = tile * kTile + j;
#pragma unroll
        for (int a = 0; a < kGA; ++a) {
          if (g0 + a < groups) {
            const float pj = s_s[(g0 + a) * chunk + jj];
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[a][e] = fmaf(pj, x[e], acc[a][e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the P.V partials
  if (pg < pgroups) {
#pragma unroll
    for (int a = 0; a < kGA; ++a) {
      if (g0 + a < groups) {
        float* dst = part_s + (pg * groups + g0 + a) * d + col * kE;
#pragma unroll
        for (int e = 0; e < kE; ++e) dst[e] = acc[a][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < groups * d; i += kThreads) {
    float o = part_s[i];
#pragma unroll 8
    for (int c = 1; c < pgroups; ++c) o += part_s[c * groups * d + i];
    const int g = i / d;
    out[g * (d + 2) + (i - g * d)] = o;
  }
  if (tid < groups) {
    out[tid * (d + 2) + d] = ml_s[2 * tid];
    out[tid * (d + 2) + d + 1] = ml_s[2 * tid + 1];
  }
}

// Tensor cores, bf16, D = kD (a multiple of 16), G <= 8 * kNT.  Each warp
// streams its own tiles of 16 positions (tiles w, w + kMmaWarps, ... of the
// chunk), K and V together, through its own ring of cp.async stages, and
// keeps a running max, sum and P.V in registers (online softmax), so no
// block-wide barrier stands between a tile's arrival and its use.  The
// products are taken transposed, positions and D as the 16 rows of the A
// fragments and the query rows as the 8 columns of B, so G = 4 wastes half
// an 8-wide tile instead of three quarters of a 16-row one:
//   S^T = K q^T     A = a K tile (ldmatrix), B = q^T (registers);
//   O^T += V^T P^T  A = the V tile transposed (ldmatrix.trans), B = P^T,
//                   which a warp passes through shared memory once per
//                   tile, as three bf16 parts hi + mid + lo = p exactly.
// The warps' (m, l, o) are merged in warp order at the end.
template <int kD, int kNT>
__device__ __forceinline__ void split_tensor_cores(const __nv_bfloat16* __restrict__ q,
                                                   const __nv_bfloat16* __restrict__ k_cache,
                                                   const __nv_bfloat16* __restrict__ v_cache,
                                                   const int32_t* __restrict__ pos,
                                                   float* __restrict__ partial, int kvh,
                                                   int groups, long long seq, long long window,
                                                   int chunk, int splits, float scale) {
  constexpr int kVpr = kD / 8;                 // 16-byte vectors per row
  constexpr int kDTiles = kD / 16;             // score k-steps; P.V row tiles of D
  constexpr int kQ = 8 * kNT;                  // query rows, G padded
  constexpr int kRow = 4 * mma_words(kD / 2);  // bytes per shared row of q, K, V
  constexpr int kTileBytes = kMmaTile * kRow;
  constexpr int kStageBytes = 2 * kTileBytes;  // K then V
  constexpr int kPRow = 4 * mma_words(kMmaTile / 2);  // bytes per row of P^T parts
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_h = smem;                                  // bf16 [kQ][kD], rows past G zero
  unsigned char* ring = smem + kQ * kRow;                     // [warp][stage][K | V][16][kD]
  unsigned char* p_h = ring + kMmaWarps * kMmaStages * kStageBytes;  // [warp][3][kQ][16]
  float* red = reinterpret_cast<float*>(ring);  // after the loop: [warp][kQ][kD + 2]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int fq = lane >> 2;       // B column, C row of the fragments
  const int fc = (lane & 3) * 2;  // B row pair, C column pair
  const long long row = blockIdx.x;  // b * kvh + h
  const int split = blockIdx.y;

  // the query block first: it does not wait on pos
  const __nv_bfloat16* qb = q + row * groups * kD;
  for (int i = tid; i < kQ * kVpr; i += kMmaThreads) {
    const int g = i / kVpr;
    const int c = i - g * kVpr;
    *reinterpret_cast<uint4*>(q_h + g * kRow + c * 16) =
        g < groups ? __ldg(reinterpret_cast<const uint4*>(qb + g * kD) + c)
                   : make_uint4(0u, 0u, 0u, 0u);
  }

  const long long b = row / kvh;
  const int h = static_cast<int>(row % kvh);
  const long long p = pos[b];
  const long long lo = p - window > 0 ? p - window : 0;
  const long long hi = p < seq ? p : seq;
  const long long c_lo = lo + static_cast<long long>(split) * chunk;
  const long long left = hi - c_lo;
  const int n = left <= 0 ? 0 : (left < chunk ? static_cast<int>(left) : chunk);
  float* out = partial + (row * splits + split) * groups * (kD + 2);
  if (n == 0) {  // uniform over the block: a chunk past the window
    for (int i = tid; i < groups * (kD + 2); i += kMmaThreads)
      out[i] = i % (kD + 2) == kD ? -INFINITY : 0.0f;
    return;
  }

  const long long row_elems = static_cast<long long>(kvh) * kD;
  const long long base = (b * seq + c_lo) * row_elems + static_cast<long long>(h) * kD;
  const __nv_bfloat16* kb = k_cache + base;
  const __nv_bfloat16* vb = v_cache + base;
  const int tiles = (n + kMmaTile - 1) / kMmaTile;
  const int mine = tiles > warp ? (tiles - warp + kMmaWarps - 1) / kMmaWarps : 0;
  unsigned char* wring = ring + warp * kMmaStages * kStageBytes;
  unsigned char* wp = p_h + warp * 3 * kQ * kPRow;
  auto issue = [=](int i) {
    const int tile = warp + i * kMmaWarps;
    const int rows = min(kMmaTile, n - tile * kMmaTile);
    unsigned char* dst = wring + (i % kMmaStages) * kStageBytes;
    const long long off = static_cast<long long>(tile) * kMmaTile * row_elems;
    for (int idx = lane; idx < rows * kVpr; idx += 32) {
      const int r = idx / kVpr;
      const int c = idx - r * kVpr;
      cp_async16(dst + r * kRow + c * 16, kb + off + r * row_elems + c * 8);
      cp_async16(dst + kTileBytes + r * kRow + c * 16, vb + off + r * row_elems + c * 8);
    }
    for (int idx = rows * kVpr + lane; idx < kMmaTile * kVpr; idx += 32) {
      const int r = idx / kVpr;  // V rows past the window: zeros, not stale bits
      *reinterpret_cast<uint4*>(dst + kTileBytes + r * kRow + (idx - r * kVpr) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  };
#pragma unroll
  for (int i = 0; i < kMmaStages - 1; ++i) {
    if (i < mine) issue(i);
    cp_async_commit();
  }
  __syncthreads();  // q_h is written

  uint32_t qf[kNT][kDTiles][2];  // the B fragments of q^T: column fq of each 8-row tile
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int ks = 0; ks < kDTiles; ++ks) {
      const unsigned char* q0 = q_h + (nt * 8 + fq) * kRow + (ks * 16 + fc) * 2;
      qf[nt][ks][0] = *reinterpret_cast<const uint32_t*>(q0);
      qf[nt][ks][1] = *reinterpret_cast<const uint32_t*>(q0 + 16);
    }
  // ldmatrix row addresses: A of K (positions x D) and A of V^T (D x positions)
  const int k_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int k_col = (lane >> 4) * 16;  // bytes
  const int v_row = (lane & 7) + (lane >> 4) * 8;
  const int v_col = ((lane >> 3) & 1) * 16;
  // this lane's query rows nt * 8 + fc + {0, 1}
  float m_run[kNT][2];
  float l_run[kNT][2];  // this lane's share of the row sums
  float acc[kNT][kDTiles][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    m_run[nt][0] = m_run[nt][1] = -INFINITY;
    l_run[nt][0] = l_run[nt][1] = 0.0f;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][dt][e] = 0.0f;
  }

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kMmaStages - 2>();
    __syncwarp();  // tile i has landed for the warp; slot (i - 1) is free
    if (i + kMmaStages - 1 < mine) issue(i + kMmaStages - 1);
    cp_async_commit();
    const unsigned char* kt = wring + (i % kMmaStages) * kStageBytes;
    const unsigned char* vt = kt + kTileBytes;
    const int j0 = (warp + i * kMmaWarps) * kMmaTile;  // the tile's first position
    // s[nt][e]: position j0 + fq + 8 * (e >> 1), query row nt * 8 + fc + (e & 1)
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kDTiles; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, kt + k_row * kRow + ks * 32 + k_col);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_bf16(s[nt], a, qf[nt][ks][0], qf[nt][ks][1]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = j0 + fq + 8 * (e >> 1) < n ? s[nt][e] * scale : -INFINITY;
        tmax[e & 1] = fmaxf(tmax[e & 1], s[nt][e]);
      }
      float alpha[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // the max over the tile's 16 positions: 8 lanes
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          tmax[c] = fmaxf(tmax[c], __shfl_xor_sync(0xffffffffu, tmax[c], off));
        const float m_new = fmaxf(m_run[nt][c], tmax[c]);
        alpha[c] = m_new == -INFINITY ? 1.0f : expf(m_run[nt][c] - m_new);  // exp(-inf) = 0
        m_run[nt][c] = m_new;
      }
      float psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // p = exp(s - m) = hi + mid + lo, stored as P^T parts
        const int c = e & 1;
        const float pv = s[nt][e] == -INFINITY ? 0.0f : expf(s[nt][e] - m_run[nt][c]);
        psum[c] += pv;
        const __nv_bfloat16 p_hi = __float2bfloat16_rn(pv);
        const float r1 = pv - __bfloat162float(p_hi);
        const __nv_bfloat16 p_mid = __float2bfloat16_rn(r1);
        const __nv_bfloat16 p_lo = __float2bfloat16_rn(r1 - __bfloat162float(p_mid));
        const int at = (nt * 8 + fc + c) * kPRow + (fq + 8 * (e >> 1)) * 2;
        *reinterpret_cast<__nv_bfloat16*>(wp + at) = p_hi;
        *reinterpret_cast<__nv_bfloat16*>(wp + kQ * kPRow + at) = p_mid;
        *reinterpret_cast<__nv_bfloat16*>(wp + 2 * kQ * kPRow + at) = p_lo;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) l_run[nt][c] = fmaf(l_run[nt][c], alpha[c], psum[c]);
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        acc[nt][dt][0] *= alpha[0];
        acc[nt][dt][1] *= alpha[1];
        acc[nt][dt][2] *= alpha[0];
        acc[nt][dt][3] *= alpha[1];
      }
    }
    __syncwarp();  // the P^T parts are written
    uint32_t pf[kNT][3][2];  // the B fragments of P^T: column fq, position pairs fc and fc + 8
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        const unsigned char* pr = wp + (part * kQ + nt * 8 + fq) * kPRow + fc * 2;
        pf[nt][part][0] = *reinterpret_cast<const uint32_t*>(pr);
        pf[nt][part][1] = *reinterpret_cast<const uint32_t*>(pr + 16);
      }
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, vt + v_row * kRow + dt * 32 + v_col);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int part = 0; part < 3; ++part)
          mma_bf16(acc[nt][dt], a, pf[nt][part][0], pf[nt][part][1]);
    }
    __syncwarp();  // the P^T parts are read before the next tile writes them
  }
  cp_async_wait<0>();
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c)  // the row sums over the 8 lanes of a query row
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l_run[nt][c] += __shfl_xor_sync(0xffffffffu, l_run[nt][c], off);
  __syncthreads();  // every warp is done with the ring: it takes the warps' partials
  float* wred = red + warp * kQ * (kD + 2);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    float* r0 = wred + (nt * 8 + fc) * (kD + 2);
    float* r1 = r0 + (kD + 2);
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {  // acc[nt][dt][e]: d = dt * 16 + fq + 8 * (e >> 1)
      r0[dt * 16 + fq] = acc[nt][dt][0];
      r1[dt * 16 + fq] = acc[nt][dt][1];
      r0[dt * 16 + fq + 8] = acc[nt][dt][2];
      r1[dt * 16 + fq + 8] = acc[nt][dt][3];
    }
    if (fq == 0) {
      r0[kD] = m_run[nt][0];
      r0[kD + 1] = l_run[nt][0];
      r1[kD] = m_run[nt][1];
      r1[kD + 1] = l_run[nt][1];
    }
  }
  __syncthreads();
  for (int i = tid; i < groups * (kD + 2); i += kMmaThreads) {
    const int g = i / (kD + 2);
    const int c = i - g * (kD + 2);
    float m_max = -INFINITY;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) m_max = fmaxf(m_max, red[(w * kQ + g) * (kD + 2) + kD]);
    float v = m_max;
    if (c != kD) {  // o or l: the warps in warp order, weight 0 for a warp with no positions
      v = 0.0f;
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w) {
        const float m = red[(w * kQ + g) * (kD + 2) + kD];
        if (m != -INFINITY) v = fmaf(red[(w * kQ + g) * (kD + 2) + c], expf(m - m_max), v);
      }
    }
    out[i] = v;
  }
}

// The last block of a row to finish (an integer counter per row, reset to
// zero by that block, so the wrapper's counters stay zeroed between
// launches) merges the row's splits: one thread per output element, the
// splits in split order.  No float atomics: the result does not depend on
// which block comes last.
template <typename T>
__device__ __forceinline__ void combine_if_last(const float* __restrict__ partial,
                                                T* __restrict__ out,
                                                unsigned* __restrict__ counters, long long row,
                                                int groups, int d, int splits) {
  __shared__ unsigned last;
  __threadfence();  // this block's partial is visible before the count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + row, 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long split_stride = static_cast<long long>(groups) * (d + 2);
  const float* rbase = partial + row * splits * split_stride;
  for (int i = threadIdx.x; i < groups * d; i += blockDim.x) {
    const int g = i / d;
    const float* base = rbase + g * (d + 2);
    float m_max = -INFINITY;
#pragma unroll 16
    for (int s = 0; s < splits; ++s) m_max = fmaxf(m_max, __ldcg(base + s * split_stride + d));
    float den = 0.0f;
    float acc = 0.0f;
#pragma unroll 16
    for (int s = 0; s < splits; ++s) {
      const float* ps = base + s * split_stride;
      const float m = __ldcg(ps + d);
      const float w = m == -INFINITY ? 0.0f : expf(m - m_max);  // empty split: weight 0
      den = fmaf(__ldcg(ps + d + 1), w, den);
      acc = fmaf(__ldcg(ps + (i - g * d)), w, acc);
    }
    out[row * groups * d + i] = Io<T>::from_float(acc / fmaxf(den, kSumFloor));
  }
  if (threadIdx.x == 0) counters[row] = 0u;
}

template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
swa_split_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                 const T* __restrict__ v_cache, const int32_t* __restrict__ pos,
                 float* __restrict__ partial, T* __restrict__ out, unsigned* __restrict__ counters,
                 int kvh, int groups, int d, long long seq, long long window, int chunk,
                 int splits, int stride, int pgroups, float scale) {
  split_cuda_cores<T, kG>(q, k_cache, v_cache, pos, partial, kvh, groups, d, seq, window, chunk,
                          splits, stride, pgroups, scale);
  combine_if_last(partial, out, counters, blockIdx.x, groups, d, splits);
}

template <int kD, int kNT>
__global__ void __launch_bounds__(kMmaThreads)
swa_split_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k_cache,
                     const __nv_bfloat16* __restrict__ v_cache, const int32_t* __restrict__ pos,
                     float* __restrict__ partial, __nv_bfloat16* __restrict__ out,
                     unsigned* __restrict__ counters, int kvh, int groups, long long seq,
                     long long window, int chunk, int splits, float scale) {
  split_tensor_cores<kD, kNT>(q, k_cache, v_cache, pos, partial, kvh, groups, seq, window,
                              chunk, splits, scale);
  combine_if_last(partial, out, counters, blockIdx.x, groups, kD, splits);
}

constexpr int kMaxDevices = 64;

// Raises `kernel`'s dynamic shared memory to `bytes` on the current device,
// where `bytes` plus the kernel's static `fixed` bytes fit a block;
// `granted` (the kernel's own, per device) remembers what was set, so the
// attribute calls are made once and not on every decode step.
template <typename Kernel>
int reserve_shared(Kernel kernel, long long bytes, long long fixed, long long* granted) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool known = device < kMaxDevices;
  if (known && bytes <= granted[device]) return 0;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes + fixed > limit) return kErrSharedMemory;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && known) granted[device] = bytes;
  return static_cast<int>(err);
}

template <typename T, int kG>
int launch_split(const T* q, const T* k_cache, const T* v_cache, const int32_t* pos,
                 float* partial, T* out, unsigned* counters, long long rows, long long seq,
                 int kvh, int groups, int d, long long window, int chunk, int splits,
                 float scale, cudaStream_t stream) {
  constexpr int kE = Io<T>::kVec;
  constexpr int kGA = pv_rows<T, kG>();
  const int vpr = d / kE;
  const int items = vpr * ((groups + kGA - 1) / kGA);
  if (items > kThreads) return kErrShape;
  const int pgroups = kThreads / items;
  const int stride = cuda_core_words(vpr * 4) * 4;
  const long long bytes = smem_bytes(groups, d, chunk, stride, pgroups);
  static long long granted[kMaxDevices] = {};
  // the static ml_s shares the block's shared memory
  const int err = reserve_shared(swa_split_kernel<T, kG>, bytes,
                                 static_cast<long long>(2 * kMaxGroups * sizeof(float)), granted);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(splits));
  swa_split_kernel<T, kG><<<grid, kThreads, static_cast<size_t>(bytes), stream>>>(
      q, k_cache, v_cache, pos, partial, out, counters, kvh, groups, d, seq, window, chunk,
      splits, stride, pgroups, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kD, int kNT>
int launch_split_mma(const __nv_bfloat16* q, const __nv_bfloat16* k_cache,
                     const __nv_bfloat16* v_cache, const int32_t* pos, float* partial,
                     __nv_bfloat16* out, unsigned* counters, long long rows, long long seq,
                     int kvh, int groups, long long window, int chunk, int splits, float scale,
                     cudaStream_t stream) {
  constexpr int kQ = 8 * kNT;
  constexpr int kRow = 4 * mma_words(kD / 2);
  constexpr int kRing = kMmaWarps * kMmaStages * 2 * kMmaTile * kRow;
  constexpr int kRed = kMmaWarps * kQ * (kD + 2) * 4;
  constexpr int kP = kMmaWarps * 3 * kQ * 4 * mma_words(kMmaTile / 2);
  constexpr int kBytes = kQ * kRow + (kRing > kRed ? kRing : kRed) + kP;
  static_assert(kRing >= kRed, "the warps' partials reuse the ring");
  static long long granted[kMaxDevices] = {};
  const int err = reserve_shared(swa_split_mma_kernel<kD, kNT>, kBytes, 0, granted);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(splits));
  swa_split_mma_kernel<kD, kNT><<<grid, kMmaThreads, kBytes, stream>>>(
      q, k_cache, v_cache, pos, partial, out, counters, kvh, groups, seq, window, chunk, splits,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_split_mma(const __nv_bfloat16* q, const __nv_bfloat16* k_cache,
                     const __nv_bfloat16* v_cache, const int32_t* pos, float* partial,
                     __nv_bfloat16* out, unsigned* counters, long long rows, long long seq,
                     int kvh, int groups, long long window, int chunk, int splits, float scale,
                     cudaStream_t stream) {
  return groups <= 8 ? launch_split_mma<kD, 1>(q, k_cache, v_cache, pos, partial, out, counters,
                                               rows, seq, kvh, groups, window, chunk, splits,
                                               scale, stream)
                     : launch_split_mma<kD, 2>(q, k_cache, v_cache, pos, partial, out, counters,
                                               rows, seq, kvh, groups, window, chunk, splits,
                                               scale, stream);
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* pos,
           void* out, void* partial, void* counters, long long batch, long long seq, int kvh,
           int groups, int d, long long window, int chunk, int splits, float scale,
           cudaStream_t stream) {
  constexpr int kE = Io<T>::kVec;
  if (batch <= 0 || kvh <= 0) return static_cast<int>(cudaSuccess);
  if (groups < 1 || groups > kMaxGroups || d < kE || d % kE != 0 || seq < 0 || window < 0 ||
      chunk < kTile || chunk % kTile != 0 || splits < 1 || splits > 65535)
    return kErrShape;
  const long long rows = batch * kvh;
  if (rows > 0x7fffffffLL) return kErrShape;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k_cache);
  const T* vt = static_cast<const T*>(v_cache);
  const int32_t* pt = static_cast<const int32_t*>(pos);
  float* part = static_cast<float*>(partial);
  T* ot = static_cast<T*>(out);
  unsigned* cnt = static_cast<unsigned*>(counters);
  if constexpr (sizeof(T) == 2) {  // the head widths of the LM configs on the tensor cores
    if (d == 64)
      return launch_split_mma<64>(qt, kt, vt, pt, part, ot, cnt, rows, seq, kvh, groups, window,
                                  chunk, splits, scale, stream);
    if (d == 80)
      return launch_split_mma<80>(qt, kt, vt, pt, part, ot, cnt, rows, seq, kvh, groups, window,
                                  chunk, splits, scale, stream);
    if (d == 128)
      return launch_split_mma<128>(qt, kt, vt, pt, part, ot, cnt, rows, seq, kvh, groups,
                                   window, chunk, splits, scale, stream);
  }
  return groups <= 4 ? launch_split<T, 4>(qt, kt, vt, pt, part, ot, cnt, rows, seq, kvh, groups,
                                          d, window, chunk, splits, scale, stream)
                     : launch_split<T, kMaxGroups>(qt, kt, vt, pt, part, ot, cnt, rows, seq, kvh,
                                                   groups, d, window, chunk, splits, scale,
                                                   stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dtype_code 0 is float32, 1 is
// bfloat16.  `partial` is float32 scratch of batch * kvh * splits * groups *
// (d + 2) elements, `counters` at least batch * kvh uint32 that are zero
// (the kernel leaves them zero); `chunk` (a multiple of 64) and `splits` are
// the wrapper's split plan, with splits * chunk >= min(window, seq).
// Launches one kernel on `stream`, does not synchronise, and returns
// cudaGetLastError(), or kErrShape / kErrSharedMemory for a refused shape.
extern "C" int swa_attention_launch(const void* q, const void* k_cache, const void* v_cache,
                                    const void* pos, void* out, void* partial, void* counters,
                                    int dtype_code, long long batch, long long seq, int kvh,
                                    int groups, int d, long long window, int chunk, int splits,
                                    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch<float>(q, k_cache, v_cache, pos, out, partial, counters, batch, seq, kvh,
                         groups, d, window, chunk, splits, scale, s);
  if (dtype_code == 1)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, pos, out, partial, counters, batch, seq,
                                 kvh, groups, d, window, chunk, splits, scale, s);
  return kErrShape;
}
