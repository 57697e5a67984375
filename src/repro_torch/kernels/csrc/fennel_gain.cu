// Fused Fennel decision over padded ELL rows, for sm_90a.
//
//   counts[b, i] = sum_w nbr_w[b, w] * [nbr_blk[b, w] == i]
//   score[b, i]  = counts[b, i] - penalty[i]      if loads[i] + node_w[b] <= cap
//                = -inf                            otherwise
//   best[b]      = first argmax_i score[b, i]      if some block is feasible
//                = first argmin_i loads[i]         otherwise
//   best_score[b] = score[b, best[b]]
//
// Replaces the Pallas kernel repro/kernels/fennel_gain.py::_fennel_kernel
// (launcher `fennel_gain`, wrapper repro/kernels/ops.py::fennel_choose_batch),
// following the oracle repro/kernels/ref.py::fennel_gain_ref where the two
// differ: an infeasible score is -inf (the Pallas kernel writes -1e30), and
// the fallback is the argmin over the k real loads (the Pallas route pads
// loads with 2*cap + 1 and can return a padded block id).  The penalty
// alpha * gamma * max(load, 0)^(gamma - 1) comes in as a (k,) vector computed
// by the wrapper with the plain version's own torch ops: CUDA's powf is not
// correctly rounded, and the chosen block must equal the plain version's.
//
// Bound: memory at the public op's shapes.  The (B, k) counts never reach
// device memory; the kernel reads B*W*8 bytes of rows and writes B*8 bytes,
// against B*W*k compares (at (32768, 64, 32): 16.8 MB and 67 M compares,
// 4 compares per byte, under the card's ~20 float32 operations per byte).
//
// Design: the histogram of csrc/ell_histogram.cu, with its epilogue fused.
// A block of 8 warps first copies loads and penalty (the shared-memory row,
// 8*k bytes) into shared memory and finds the fallback argmin there.  Then
// one warp owns one row: lane j takes labels j, j + 32, ..., walks the row's
// W entries in order for each (broadcast loads, the sum in a register, no
// atomics), applies the penalty and the feasibility mask, and keeps its
// first maximum; a shuffle reduction picks the warp's maximum with ties to
// the lower label, which is torch.argmax's first maximum.  Sums, the mask's
// add and the score's subtract are single float32 operations (__fadd_rn,
// __fsub_rn), the plain version's, so results are bit-identical to it.  A k
// whose shared-memory row does not fit a block is refused (-1), never
// rerouted.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr long long kMaxBlocks = 1024;  // the rows loop beyond; bounds the row copies
constexpr unsigned kFull = 0xffffffffu;
constexpr int kErrSharedMemory = -1;

__global__ void __launch_bounds__(kThreads)
fennel_gain_kernel(const int32_t* __restrict__ nbr_blk, const float* __restrict__ nbr_w,
                   const float* __restrict__ loads, const float* __restrict__ penalty,
                   const float* __restrict__ node_w, int32_t* __restrict__ best_out,
                   float* __restrict__ score_out, long long rows, long long width, int k,
                   float cap) {
  extern __shared__ float row[];  // loads[0, k), penalty[k, 2k)
  __shared__ float red_v[kThreads];
  __shared__ int red_i[kThreads];
  const int tid = threadIdx.y * 32 + threadIdx.x;

  // the shared-memory row, and each thread's first minimum of its labels
  float min_v = INFINITY;
  int min_i = INT_MAX;
  for (int i = tid; i < k; i += kThreads) {
    const float ld = loads[i];
    row[i] = ld;
    row[k + i] = penalty[i];
    if (min_i == INT_MAX || ld < min_v) {
      min_v = ld;
      min_i = i;
    }
  }
  red_v[tid] = min_v;
  red_i[tid] = min_i;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      const float ov = red_v[tid + stride];
      const int oi = red_i[tid + stride];
      if (oi != INT_MAX &&
          (red_i[tid] == INT_MAX || ov < red_v[tid] || (ov == red_v[tid] && oi < red_i[tid]))) {
        red_v[tid] = ov;
        red_i[tid] = oi;
      }
    }
    __syncthreads();
  }
  const int fallback = red_i[0];

  const int lane = threadIdx.x;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.y;
       r < rows; r += static_cast<long long>(gridDim.x) * kWarpsPerBlock) {
    const int32_t* blk = nbr_blk + r * width;
    const float* wts = nbr_w + r * width;
    const float nw = __ldg(node_w + r);
    float best_v = -INFINITY;
    int best_i = INT_MAX;
    bool feasible = false;
    for (int label = lane; label - lane < k; label += 32) {
      float acc = 0.0f;
      for (long long j = 0; j < width; ++j) {
        if (__ldg(blk + j) == label) acc = __fadd_rn(acc, __ldg(wts + j));
      }
      if (label < k) {
        const bool ok = __fadd_rn(row[label], nw) <= cap;
        const float s = ok ? __fsub_rn(acc, row[k + label]) : -INFINITY;
        feasible |= ok;
        if (best_i == INT_MAX || s > best_v) {
          best_v = s;
          best_i = label;
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(kFull, best_v, off);
      const int oi = __shfl_down_sync(kFull, best_i, off);
      if (oi != INT_MAX &&
          (best_i == INT_MAX || ov > best_v || (ov == best_v && oi < best_i))) {
        best_v = ov;
        best_i = oi;
      }
    }
    const bool any_ok = __any_sync(kFull, feasible);
    if (lane == 0) {
      best_out[r] = any_ok ? best_i : fallback;
      score_out[r] = any_ok ? best_v : -INFINITY;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` on the
// current device, does not synchronise, and returns cudaGetLastError(), or
// -1 when the 8*k-byte shared-memory row does not fit a block.
extern "C" int fennel_gain_launch(const void* nbr_blk, const void* nbr_w, const void* loads,
                                  const void* penalty, const void* node_w, void* best,
                                  void* score, long long rows, long long width, int k,
                                  float cap, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  int device = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t static_bytes = kThreads * (sizeof(float) + sizeof(int));
  const size_t bytes = 2 * sizeof(float) * static_cast<size_t>(k);
  if (bytes + static_bytes > static_cast<size_t>(optin)) return kErrSharedMemory;
  err = cudaFuncSetAttribute(fennel_gain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dim3 grid(static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks));
  dim3 block(32, kWarpsPerBlock);
  fennel_gain_kernel<<<grid, block, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nbr_blk), static_cast<const float*>(nbr_w),
      static_cast<const float*>(loads), static_cast<const float*>(penalty),
      static_cast<const float*>(node_w), static_cast<int32_t*>(best),
      static_cast<float*>(score), rows, width, k, cap);
  return static_cast<int>(cudaGetLastError());
}
