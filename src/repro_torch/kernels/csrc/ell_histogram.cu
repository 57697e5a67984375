// Weighted neighbor-label histogram over padded ELL rows, for sm_90a.
//
//   counts[b, i] = sum_w nbr_w[b, w] * [nbr_blk[b, w] == i]
//
// Replaces the Pallas kernel repro/kernels/ell_histogram.py::_histogram_kernel
// (launcher `ell_histogram`, wrapper repro/kernels/ops.py::block_histogram).
//
// Bound: memory at the main path's shapes.  Each (row, label) output needs
// W compares, so the work is B*W*k compares (plus one add per valid entry)
// against B*W*8 bytes read and B*k*4 bytes written; at (65536, 8, 32) that
// is 1.3 operations per byte, far below the card's ~20 float32 operations
// per byte of device memory.  Only at cluster-sized k (thousands) does the
// compare count approach that line.
//
// Design: one warp owns one row and a tile of 32 consecutive label columns;
// lane j of the warp owns label column (tile*32 + j) and walks the row's W
// entries in order, comparing and accumulating in a register.  All lanes of
// a warp read the same (label, weight) entry at each step, so each load is
// one broadcast transaction, and the warp's 32 results are one coalesced
// 128-byte store.  A block is 8 warps on 8 consecutive rows.  Large k (the
// clustering phase uses k = n_pad, cluster labels being node ids) spreads
// over the grid's label-tile dimension, which is the TPU kernel's MAX_KC
// tiling done with grid blocks.  There are no atomics: every output element
// is written once by one thread that summed in w order, so the result is
// bit-deterministic.  B, W and k need no padding; the ragged label tile is
// masked at the store.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLabelsPerWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr long long kMaxRowTiles = 1LL << 20;  // grid.x cap; rows loop beyond it
constexpr long long kMaxLabelTiles = 65535;    // grid.y hardware limit

__global__ void __launch_bounds__(kLabelsPerWarp * kRowsPerBlock)
ell_histogram_kernel(const int32_t* __restrict__ nbr_blk,
                     const float* __restrict__ nbr_w,
                     float* __restrict__ counts,
                     long long rows, long long width, long long k) {
  for (long long tile = blockIdx.y; tile * kLabelsPerWarp < k; tile += gridDim.y) {
    const long long label = tile * kLabelsPerWarp + threadIdx.x;
    const int32_t label32 = static_cast<int32_t>(label);
    for (long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
         row < rows; row += static_cast<long long>(gridDim.x) * kRowsPerBlock) {
      const int32_t* blk = nbr_blk + row * width;
      const float* wts = nbr_w + row * width;
      float acc = 0.0f;
      for (long long j = 0; j < width; ++j) {
        if (__ldg(blk + j) == label32) acc += __ldg(wts + j);
      }
      if (label < k) counts[row * k + label] = acc;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so a refused launch is seen.
extern "C" int ell_histogram_launch(const void* nbr_blk, const void* nbr_w, void* counts,
                                    long long rows, long long width, long long k,
                                    void* stream) {
  if (rows <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  long long row_tiles = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  long long label_tiles = (k + kLabelsPerWarp - 1) / kLabelsPerWarp;
  dim3 grid(static_cast<unsigned>(row_tiles < kMaxRowTiles ? row_tiles : kMaxRowTiles),
            static_cast<unsigned>(label_tiles < kMaxLabelTiles ? label_tiles : kMaxLabelTiles));
  dim3 block(kLabelsPerWarp, kRowsPerBlock);
  ell_histogram_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nbr_blk), static_cast<const float*>(nbr_w),
      static_cast<float*>(counts), rows, width, k);
  return static_cast<int>(cudaGetLastError());
}
