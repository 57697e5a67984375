// Weighted neighbor-label histogram over padded ELL rows, for sm_90a.
//
//   counts[b, i] = sum_w nbr_w[b, w] * [nbr_blk[b, w] == i]
//
// Replaces the Pallas kernel repro/kernels/ell_histogram.py::_histogram_kernel
// (launcher `ell_histogram`, wrapper repro/kernels/ops.py::block_histogram).
//
// Bound: memory.  The function reads B*W*8 bytes and writes B*k*4, two
// thirds of them the (B, k) output at the refinement shape (65536, 8, 32),
// and nearly all of them at the clustering shapes, where k is the number of
// nodes and the output is mostly zeros.  The compares (B*W*k, or far fewer
// below) stay under the card's float32 rate.  A first version (one warp per
// row and 32 labels, each lane walking W with two dependent scalar loads per
// step and storing 4 bytes) kept too few bytes in flight to approach that
// bound; this design keeps the loads independent and the stores wide.
//
// A group of up to 32 threads owns a row; each thread owns runs of 4
// adjacent labels.  It reads the row's labels and weights with 16-byte loads
// (all of them independent, so they are in flight together; the group's
// threads read the same bytes, one transaction per warp), walks W in order
// comparing each label with its run, and writes the 4 sums with one 16-byte
// streaming store (st.global.cs).  W is a template parameter for the ELL
// widths the path uses (8, 16, 32, 64: the padded widths are powers of two,
// at least 8), fully unrolled; every other width takes a runtime loop with
// scalar loads.  At the clustering's large label domains (k = n_pad) the
// kernel stays bound by writing the mostly-zero output: a form that
// zero-fills a (rows, labels) tile in shared memory and adds only a row's W
// entries into it measured slower there on the H100 (PERF.md), so there is
// one form.
// Every output element is summed by one thread, in w order, starting from
// 0.0f, with no atomics: the result is bit-deterministic and equal to the
// plain version's column-by-column float32 sums.  Labels of -1 or >= k match
// nothing.  B, W and k need no padding; a k that is not a multiple of 4 takes
// scalar stores (its rows are not 16-byte aligned).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroupThreads = 32;          // threads per row
constexpr long long kMaxRowBlocks = 1LL << 20;  // grid cap; rows loop beyond it

constexpr int kErrShape = -2;

// Adds weight x into the run of 4 labels at `base` if its label falls there.
// Unsigned arithmetic: a label of -1 (or below base) wraps past any run.
__device__ __forceinline__ void add_to_run(int32_t label, float x, uint32_t base, float4& a) {
  const uint32_t d = static_cast<uint32_t>(label) - base;
  if (d < 4u) {  // adding 0.0f to the other three leaves them bit for bit
    a.x += d == 0u ? x : 0.0f;
    a.y += d == 1u ? x : 0.0f;
    a.z += d == 2u ? x : 0.0f;
    a.w += d == 3u ? x : 0.0f;
  }
}

template <bool kVec4>
__device__ __forceinline__ void store_run(float* row_out, long long label, long long k, float4 a) {
  if (kVec4) {
    __stcs(reinterpret_cast<float4*>(row_out + label), a);
  } else {
    __stcs(row_out + label, a.x);  // label < k
    if (label + 1 < k) __stcs(row_out + label + 1, a.y);
    if (label + 2 < k) __stcs(row_out + label + 2, a.z);
    if (label + 3 < k) __stcs(row_out + label + 3, a.w);
  }
}

// kW > 0: the width, a multiple of 4 with 16-byte aligned rows; 0: `width`.
template <int kW, bool kVec4>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const int32_t* __restrict__ nbr_blk, const float* __restrict__ nbr_w,
            float* __restrict__ counts, long long rows, int width, long long k, int group_log2) {
  const int w_len = kW > 0 ? kW : width;
  const int group = 1 << group_log2;
  const int sub = threadIdx.x & (group - 1);
  const int rows_per_block = kThreads >> group_log2;
  const long long runs = (k + 3) / 4;
  for (long long row = static_cast<long long>(blockIdx.x) * rows_per_block +
                       (threadIdx.x >> group_log2);
       row < rows; row += static_cast<long long>(gridDim.x) * rows_per_block) {
    const int32_t* blk = nbr_blk + row * w_len;
    const float* wts = nbr_w + row * w_len;
    float* out = counts + row * k;
    for (long long run = sub; run < runs; run += group) {
      const uint32_t base = static_cast<uint32_t>(run * 4);  // < k <= 2^31 - 1
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (kW > 0) {
#pragma unroll
        for (int w = 0; w < kW; w += 4) {
          const int4 l4 = __ldg(reinterpret_cast<const int4*>(blk + w));
          const float4 x4 = __ldg(reinterpret_cast<const float4*>(wts + w));
          add_to_run(l4.x, x4.x, base, a);
          add_to_run(l4.y, x4.y, base, a);
          add_to_run(l4.z, x4.z, base, a);
          add_to_run(l4.w, x4.w, base, a);
        }
      } else {
        for (int w = 0; w < w_len; ++w) add_to_run(__ldg(blk + w), __ldg(wts + w), base, a);
      }
      store_run<kVec4>(out, run * 4, k, a);
    }
  }
}

long long cap(long long x, long long limit) { return x < limit ? x : limit; }

template <int kW, bool kVec4>
int launch_rows(const int32_t* blk, const float* wts, float* counts, long long rows, int width,
                long long k, cudaStream_t stream) {
  const long long runs = (k + 3) / 4;
  int group_log2 = 0;
  while ((1LL << group_log2) < runs && (1 << group_log2) < kMaxGroupThreads) ++group_log2;
  const long long per_block = kThreads >> group_log2;
  const long long blocks = cap((rows + per_block - 1) / per_block, kMaxRowBlocks);
  hist_kernel<kW, kVec4><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      blk, wts, counts, rows, width, k, group_log2);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec4>
int launch_width(const int32_t* blk, const float* wts, float* counts, long long rows,
                 long long width, long long k, cudaStream_t stream) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(blk) | reinterpret_cast<uintptr_t>(wts)) % 16 == 0;
  const int w = static_cast<int>(width);
  if (aligned) {
    switch (w) {
      case 8: return launch_rows<8, kVec4>(blk, wts, counts, rows, w, k, stream);
      case 16: return launch_rows<16, kVec4>(blk, wts, counts, rows, w, k, stream);
      case 32: return launch_rows<32, kVec4>(blk, wts, counts, rows, w, k, stream);
      case 64: return launch_rows<64, kVec4>(blk, wts, counts, rows, w, k, stream);
      default: break;
    }
  }
  return launch_rows<0, kVec4>(blk, wts, counts, rows, w, k, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so a refused launch is seen,
// or kErrShape.
extern "C" int ell_histogram_launch(const void* nbr_blk, const void* nbr_w, void* counts,
                                    long long rows, long long width, long long k, void* stream) {
  if (rows <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  if (width < 0 || width > 0x7fffffffLL || k > 0x7fffffffLL) return kErrShape;
  const int32_t* blk = static_cast<const int32_t*>(nbr_blk);
  const float* wts = static_cast<const float*>(nbr_w);
  float* out = static_cast<float*>(counts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = k % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec4 ? launch_width<true>(blk, wts, out, rows, width, k, s)
              : launch_width<false>(blk, wts, out, rows, width, k, s);
}
