// Embedding bag (gather and weighted sum) over stacked tables, for sm_90a.
//
//   out[b, t, :] = sum_l table[t, clamp(idx[b, t, l], 0, V - 1), :] * mask[b, t, l]
//
// table (T, V, D) float32, idx (B, T, L) int32, mask (B, T, L) float32,
// out (B, T, D) float32; the 2-D form of the wrapper is T = 1.
//
// Replaces the Pallas kernel repro/kernels/embedding_bag.py::_bag_kernel
// (launcher `embedding_bag`, a scalar-prefetch grid of one (bag, slot) per
// step, vmapped over the 26 stacked tables by repro/models/dlrm.py) and what
// its wrapper repro/kernels/ops.py::embedding_bag does around it: the clamp
// of idx to [0, V) happens here as each index is read, and D is not padded.
//
// Bound: memory.  Each slot reads one D-float row and does D multiplies and
// adds, a quarter of an operation per byte, far below the card's ~20 float32
// operations per byte of device memory.  At DLRM's serve_bulk shape
// (B = 262144, T = 26, L = 1, D = 128) the rows read and the pooled output
// written are 3.49 GB each.
//
// Design: one warp per bag (b, t).  Lane j owns the 16-byte vectors
// j, j + 32, ... of the row, so a 512-byte row (D = 128) is one coalesced
// read by the warp and the pooled row one coalesced store.  Each lane walks
// the bag's L slots in order from a zero accumulator, as a multiply and then
// an add (__fmul_rn, __fadd_rn: nvcc would otherwise contract them into an
// FMA), so the result equals the plain version's loop bit for bit.  Table
// offsets are 64-bit: the stacked tables hold 3.49e9 floats, past 2^31.
// A D that is not a multiple of 4, or a table not 16-byte aligned, takes the
// same kernel with 4-byte loads.  A block is 8 warps on 8 consecutive bags;
// no atomics, every output element is written once.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr long long kMaxBlocks = 1LL << 20;  // grid.x cap; bags loop beyond it

__device__ __forceinline__ float4 load_vec(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float load_vec(const float* p) { return __ldg(p); }

__device__ __forceinline__ float4 mul_add(float4 acc, float4 r, float m) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(r.x, m));
  acc.y = __fadd_rn(acc.y, __fmul_rn(r.y, m));
  acc.z = __fadd_rn(acc.z, __fmul_rn(r.z, m));
  acc.w = __fadd_rn(acc.w, __fmul_rn(r.w, m));
  return acc;
}
__device__ __forceinline__ float mul_add(float acc, float r, float m) {
  return __fadd_rn(acc, __fmul_rn(r, m));
}

template <typename Vec>
__device__ __forceinline__ Vec zero_vec();
template <>
__device__ __forceinline__ float4 zero_vec<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <>
__device__ __forceinline__ float zero_vec<float>() { return 0.f; }

template <typename Vec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
embedding_bag_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx,
                     const float* __restrict__ mask, float* __restrict__ out,
                     long long bags, long long n_tables, long long vocab, long long dim,
                     long long bag_len) {
  constexpr long long kVec = sizeof(Vec) / sizeof(float);
  const long long nvec = dim / kVec;
  for (long long bag = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.y;
       bag < bags; bag += static_cast<long long>(gridDim.x) * kWarpsPerBlock) {
    const float* tab = table + (bag % n_tables) * vocab * dim;
    const int32_t* ib = idx + bag * bag_len;
    const float* mb = mask + bag * bag_len;
    Vec* ob = reinterpret_cast<Vec*>(out + bag * dim);
    for (long long v = threadIdx.x; v < nvec; v += 32) {
      Vec acc = zero_vec<Vec>();
      for (long long l = 0; l < bag_len; ++l) {
        long long row = __ldg(ib + l);
        row = row < 0 ? 0 : (row >= vocab ? vocab - 1 : row);
        const Vec* r = reinterpret_cast<const Vec*>(tab + row * dim) + v;
        acc = mul_add(acc, load_vec(r), __ldg(mb + l));
      }
      ob[v] = acc;
    }
  }
}

template <typename Vec>
int launch(const void* table, const void* idx, const void* mask, void* out, long long bags,
           long long n_tables, long long vocab, long long dim, long long bag_len,
           cudaStream_t stream) {
  long long blocks = (bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dim3 grid(static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks));
  dim3 block(32, kWarpsPerBlock);
  embedding_bag_kernel<Vec><<<grid, block, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(mask), static_cast<float*>(out), bags, n_tables, vocab, dim,
      bag_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `bags` is B * T, bag `g` lies
// in table g % T.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so a refused launch is seen.
extern "C" int embedding_bag_launch(const void* table, const void* idx, const void* mask,
                                    void* out, long long bags, long long n_tables,
                                    long long vocab, long long dim, long long bag_len,
                                    void* stream) {
  if (bags <= 0 || dim <= 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = dim % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec4 ? launch<float4>(table, idx, mask, out, bags, n_tables, vocab, dim, bag_len, s)
              : launch<float>(table, idx, mask, out, bags, n_tables, vocab, dim, bag_len, s);
}
