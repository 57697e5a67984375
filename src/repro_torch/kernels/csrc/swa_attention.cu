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
// reads exactly the rows [lo, hi) straight from the (B, S, KVH, D) cache,
// so there is no copy and no padding of D or of the window.  Numerics
// follow the Pallas kernel: inputs loaded in their own type and widened to
// float32, float32 products and sums, the scale applied to the float32 dot
// product, an exact softmax (max, exp(s - m), sum, divide by
// max(sum, 1e-30)) and the output rounded to q's type.  An empty window
// (pos <= 0, or window = 0) gives zeros.
//
// Bound: memory.  Per position the kernel reads one K row and one V row
// (2 * D * sizeof(T) bytes) and does 4 * G * D flops, so G flops per byte in
// bf16 (4 at G = 4), far below the card's float32 ridge.  At the serve shape
// (B = 4, KVH = 8, G = 4, D = 80, window 4096) that is ~42 MB of K and V.
//
// Design: one block of 512 threads per (batch row, kv head), the G query
// rows of the group kept in shared memory as float32.  Three passes over
// the window, all inside the block:
//   1. each thread takes whole positions (strided by the block size),
//      loads the K row with 16-byte vector loads (a bf16 row of D = 80 is
//      160 B = 10 vectors) and writes the G scaled scores to shared memory
//      (G * min(window, S) float32: 64 KB at the serve shape, so the
//      dynamic shared memory limit is raised above 48 KB);
//   2. for each query row, a block max, exp(s - m) in place, a block sum and
//      the division, so shared memory then holds the probabilities;
//   3. threads are laid out as (query row, 16-byte column chunk of V,
//      position group); each walks its positions in order and keeps its
//      chunk's partial sums in registers; the position groups' partials
//      are added in group order through shared memory.
// Every reduction has a fixed order and there are no atomics, so the output
// is bit-deterministic.  A shape whose scores do not fit in the block's
// shared memory is refused (return code kErrSharedMemory), never rerouted.
// At B = 4 the grid is only 32 blocks on 132 SMs, which is what bounds this
// first version; splitting the window over blocks is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 16;  // query heads per kv head held in registers
constexpr float kSumFloor = 1e-30f;

constexpr int kErrSharedMemory = -1;
constexpr int kErrShape = -2;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  __device__ static void load_vec(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_float(float x) { return __float2bfloat16_rn(x); }
  __device__ static void load_vec(const __nv_bfloat16* p, float* out) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little endian: the lower address is the low half
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Block-wide max or sum with a fixed order: a butterfly in each warp, then
// the warps' results in warp order.  Every thread returns the same value.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();  // scratch may be reused at once
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                  const T* __restrict__ v_cache, const int32_t* __restrict__ pos,
                  T* __restrict__ out, int kvh, int groups, int d, long long seq,
                  long long window, int span, float scale, int pv_groups) {
  constexpr int kVec = Io<T>::kVec;
  extern __shared__ float smem[];
  float* scores = smem;                    // [groups][span]
  float* q_s = scores + groups * span;     // [groups][d]
  float* partial = q_s + groups * d;       // [pv_groups][groups][d]
  __shared__ float scratch[kWarps];

  const long long bh = blockIdx.x;
  const long long b = bh / kvh;
  const int h = static_cast<int>(bh % kvh);
  const long long p = pos[b];
  const long long lo = p - window > 0 ? p - window : 0;
  const long long hi = p < seq ? p : seq;
  const int n = hi > lo ? static_cast<int>(hi - lo) : 0;  // <= span

  const T* qb = q + bh * groups * d;
  for (int i = threadIdx.x; i < groups * d; i += kThreads) q_s[i] = Io<T>::to_float(qb[i]);
  __syncthreads();

  const long long row = static_cast<long long>(kvh) * d;  // elements per position
  const T* kb = k_cache + (b * seq + lo) * row + static_cast<long long>(h) * d;
  const T* vb = v_cache + (b * seq + lo) * row + static_cast<long long>(h) * d;

  // pass 1: scaled scores, one position per thread
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const T* kr = kb + j * row;
    float acc[kMaxGroups];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) acc[g] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < d; c += kVec) {
      float kv[kVec];
      Io<T>::load_vec(kr + c, kv);
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (g < groups) {
          const float* qg = q_s + g * d + c;
          float s = acc[g];
#pragma unroll
          for (int e = 0; e < kVec; ++e) s = fmaf(qg[e], kv[e], s);
          acc[g] = s;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g < groups) scores[g * span + j] = acc[g] * scale;
    }
  }
  __syncthreads();

  // pass 2: exact softmax of each query row, in place
  for (int g = 0; g < groups; ++g) {
    float* sg = scores + g * span;
    float m = -INFINITY;
    for (int j = threadIdx.x; j < n; j += kThreads) m = fmaxf(m, sg[j]);
    m = block_reduce<true>(m, scratch);
    float sum = 0.0f;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float e = expf(sg[j] - m);
      sg[j] = e;
      sum += e;
    }
    const float den = fmaxf(block_reduce<false>(sum, scratch), kSumFloor);
    for (int j = threadIdx.x; j < n; j += kThreads) sg[j] = sg[j] / den;
  }
  __syncthreads();

  // pass 3: P.V, one (query row, column chunk) per thread and position group
  const int chunks = d / kVec;
  const int pairs = groups * chunks;
  for (int t = threadIdx.x; t < pairs * pv_groups; t += kThreads) {
    const int pair = t % pairs;
    const int grp = t / pairs;
    const int g = pair / chunks;
    const int c = (pair % chunks) * kVec;
    const float* pg = scores + g * span;
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
#pragma unroll 4
    for (int j = grp; j < n; j += pv_groups) {
      float vv[kVec];
      Io<T>::load_vec(vb + j * row + c, vv);
      const float pj = pg[j];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmaf(pj, vv[e], acc[e]);
    }
    float* dst = partial + (grp * groups + g) * d + c;
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[e] = acc[e];
  }
  __syncthreads();

  T* ob = out + bh * groups * d;
  for (int i = threadIdx.x; i < groups * d; i += kThreads) {
    float s = partial[i];
    for (int grp = 1; grp < pv_groups; ++grp) s += partial[grp * groups * d + i];
    ob[i] = Io<T>::from_float(s);
  }
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* pos,
           void* out, long long batch, long long seq, int kvh, int groups, int d,
           long long window, float scale, cudaStream_t stream) {
  constexpr int kVec = Io<T>::kVec;
  if (batch <= 0 || kvh <= 0) return static_cast<int>(cudaSuccess);
  if (groups < 1 || groups > kMaxGroups || d < kVec || d % kVec != 0 || seq < 0 || window < 0)
    return kErrShape;
  const long long span = window < seq ? window : seq;
  const int pairs = groups * (d / kVec);
  const int pv_groups = pairs >= kThreads ? 1 : kThreads / pairs;
  const long long floats = static_cast<long long>(groups) * span +
                           static_cast<long long>(groups) * d +
                           static_cast<long long>(pv_groups) * groups * d;
  const long long bytes = floats * static_cast<long long>(sizeof(float));
  int device = 0;
  int limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the static scratch of kWarps floats shares the block's shared memory
  if (bytes + static_cast<long long>(kWarps * sizeof(float)) > limit) return kErrSharedMemory;
  err = cudaFuncSetAttribute(swa_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = batch * kvh;
  if (blocks > 0x7fffffffLL) return kErrShape;
  swa_decode_kernel<T><<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(bytes),
                         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      static_cast<const int32_t*>(pos), static_cast<T*>(out), kvh, groups, d, seq, window,
      static_cast<int>(span), scale, pv_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dtype_code 0 is float32, 1 is
// bfloat16.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError(), or kErrShape / kErrSharedMemory for a refused shape.
extern "C" int swa_attention_launch(const void* q, const void* k_cache, const void* v_cache,
                                    const void* pos, void* out, int dtype_code, long long batch,
                                    long long seq, int kvh, int groups, int d, long long window,
                                    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch<float>(q, k_cache, v_cache, pos, out, batch, seq, kvh, groups, d, window,
                         scale, s);
  if (dtype_code == 1)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, pos, out, batch, seq, kvh, groups, d,
                                 window, scale, s);
  return kErrShape;
}
