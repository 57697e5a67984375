// Fennel decisions for sm_90a: the public op's wavefront decision over
// padded ELL rows (`fennel_gain_launch`), and the V-cycle's sequential
// initial sweep over the coarsest level (`fennel_sweep_launch`).
//
// ---- fennel_gain_launch: one decision per row, all rows seeing one set of loads
//
//   counts[b, i] = sum_w nbr_w[b, w] * [nbr_blk[b, w] == i]     (float32, w order)
//   penalty[i]   = (float)(alpha * gamma) * max(loads[i], 0)^(gamma - 1)
//   score[b, i]  = counts[b, i] - penalty[i]   if loads[i] + node_w[b] <= cap, else -inf
//   best[b]      = first argmax_i score[b, i] if some block is feasible,
//                  else first argmin_i loads[i];  best_score[b] = score[b, best[b]]
//
// Replaces the Pallas kernel repro/kernels/fennel_gain.py::_fennel_kernel
// (launcher `fennel_gain`, wrapper repro/kernels/ops.py::fennel_choose_batch),
// following the oracle repro/kernels/ref.py::fennel_gain_ref where the two
// differ: an infeasible score is -inf (the Pallas kernel writes -1e30), and
// the fallback is the argmin over the k real loads (the Pallas route pads
// loads with 2*cap + 1 and can return a padded block id).
//
// Bound: memory.  The kernel reads B*W*8 bytes of rows and writes B*8; at
// (32768, 64, 32) that is 17.2 MB, 5.1 us at 3.35 TB/s.  Its work is B*W*k
// compares and predicated adds.  A compare (ISETP) issues at half rate, so
// that work alone is ~4 us of issue at that shape on 132 SMs; and each entry
// a lane compares has to reach that lane's registers, which shared memory
// delivers at 128 bytes a cycle an SM: a warp that reads one row's entries
// as broadcasts to all 32 lanes needs 2 cycles an entry, ~16 us at that
// shape.  So:
//   - k <= 32 and W a multiple of 4 take the fast kernel.  Four lanes own a
//     row, so a warp compares 8 rows at once and each 16-byte broadcast
//     load serves 4 lanes (0.25 shared-memory cycles a (row, entry)); staged
//     rows are padded by 16 bytes so that the 8 rows of a load sit in
//     different banks.  Lane `sub` of a row holds blocks sub, sub + 4, ...,
//     sub + 28 (loads, penalties and sums in registers) and adds, entry by
//     entry in w order, the weights labelled with each.  A persistent grid
//     (blocks from the SM count) gives each warp a contiguous share of the
//     rows, which it stages 8 rows at a time with 16-byte cp.async copies
//     into its own 3-stage ring: no block-wide barrier, so a warp compares
//     its first rows while the rest are in flight.  The first argmax is a
//     per-lane scan over order-preserving keys and two shuffle rounds among
//     the row's lanes; the fallback (first least-loaded block) is found once
//     per warp with a redux.
//   - Other shapes take the general kernel: a warp a row, each lane walking
//     the row from device memory for each of its labels, with loads and
//     penalty in shared memory (8*k bytes).  A k whose row does not fit
//     (k above ~29,000) takes the same kernel with the row left in device
//     memory: each lane reads its block's load and computes the penalty
//     itself.  These large-k shapes are B*W*k/32 reads a warp, far from
//     the byte bound; they are there so that the op takes every k.
// Both compute the penalty in the kernel with the float32 operations that
// torch.pow and torch.mul perform on the card (`torch_pow_f32`), so a call
// is one launch.  Sums, the feasibility add and the score's subtract are
// single float32 operations (__fadd_rn, __fsub_rn), the plain version's,
// written as intrinsics because nvcc would otherwise contract a - b*c into
// an FMA; results are bit-identical to the plain version.  No float atomics.
//
// ---- fennel_sweep_launch: the sequential Fennel sweep of the V-cycle
//
// For i in [0, n_free): v = order[i]; conn[b] = sum of ew[j] over v's edge
// segment j in [indptr[v], indptr[v+1]) in segment order, where edst[j] <
// n_pad and labels[edst[j]] = b >= 0; then the same decision in float64 (the
// penalty with torch_pow_f64, feasibility loads[b] + node_w[v] <= cap, first
// argmax or first argmin); labels[v] = best; loads[best] += node_w[v].
//
// Replaces repro/core/multilevel_jax.py::_initial_fennel, a jax.lax.fori_loop
// (not a Pallas kernel) that the reference jits whole.  Each step depends on
// the one before it (a label written one step earlier may be read by the
// next), so the sweep is one block and its time is the dependent chain:
// n_free steps of a few on-chip round trips each.  Its bytes (the segments,
// order, indptr, labels) are small.  The design keeps the chain on chip:
//   - warp 0 decides.  For k <= 32 lane b holds block b's load, penalty and
//     connection sum in registers, and only block best's penalty is
//     recomputed after a step (the others' loads did not change); for larger
//     k they live in shared memory (device memory when 24*k bytes do not fit).
//   - warp 1 stages.  Segments, order and indptr do not depend on decisions,
//     so it reads order, indptr and node_w for 32 steps at a time and copies
//     their segments (dst, weight) with 8-byte cp.async into a ring of 4096
//     entries, publishing each batch through a counter in shared memory; the
//     decision warp publishes what it has consumed.  A segment longer than
//     1024 entries (an R-MAT hub) is not staged: the decision warp reads it
//     from device memory.
//   - labels live in shared memory as int32 where n_pad of them fit beside
//     the ring (n_pad <= ~38k), else in device memory, where the warp's own
//     writes are visible to it after __syncwarp.
// Sums run in segment order, the host engines' order, so integer-weight
// parity with host `sparse` holds as for the eager loop.  Every step of the
// decision is a single float64 operation (__dadd_rn, __dsub_rn, __dmul_rn),
// and ties break to the lowest block as torch.argmax and torch.argmin do.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kErrSharedMemory = -1;
constexpr int kErrShape = -2;
constexpr int kMaxDevices = 64;

// ------------------------------------------------------------------ shared

// torch.pow(x, g1) on a float32 tensor with a Python float exponent, as
// PyTorch computes it on the card: exponent 0 fills ones and 1 copies
// (Pow.cpp); 0.5, -0.5 and -1 go to sqrt, rsqrt and reciprocal; then the
// exponent, cast to float, takes products at 2, 3 and -2 and powf otherwise
// (PowKernel.cu).
__device__ __forceinline__ float torch_pow_f32(float x, double g1) {
  if (g1 == 0.0) return 1.0f;
  if (g1 == 1.0) return x;
  if (g1 == 0.5) return __fsqrt_rn(x);
  if (g1 == -0.5) return rsqrtf(x);
  if (g1 == -1.0) return __frcp_rn(x);
  const float e = __double2float_rn(g1);
  if (e == 2.0f) return __fmul_rn(x, x);
  if (e == 3.0f) return __fmul_rn(__fmul_rn(x, x), x);
  if (e == -2.0f) return __double2float_rn(__ddiv_rn(1.0, static_cast<double>(__fmul_rn(x, x))));
  return powf(x, e);
}

// The float64 twin, for the sweep: multilevel_torch's `_pow_tensor` takes
// x*x, sqrt and 1/x at 2, 0.5 and -1 and torch.pow otherwise, which on a
// float64 tensor is the same case list with the exponent kept in double.
__device__ __forceinline__ double torch_pow_f64(double x, double g1) {
  if (g1 == 0.0) return 1.0;
  if (g1 == 1.0) return x;
  if (g1 == 0.5) return __dsqrt_rn(x);
  if (g1 == -0.5) return rsqrt(x);
  if (g1 == -1.0) return __drcp_rn(x);
  if (g1 == 2.0) return __dmul_rn(x, x);
  if (g1 == 3.0) return __dmul_rn(__dmul_rn(x, x), x);
  if (g1 == -2.0) return __ddiv_rn(1.0, __dmul_rn(x, x));
  return pow(x, g1);
}

// clamp(min=0) as torch computes it: NaN passes through.
__device__ __forceinline__ float clamp0(float x) { return isnan(x) ? x : fmaxf(x, 0.0f); }
__device__ __forceinline__ double clamp0(double x) { return isnan(x) ? x : fmax(x, 0.0); }

__device__ __forceinline__ float penalty_f32(float load, float ag, double g1) {
  return __fmul_rn(ag, torch_pow_f32(clamp0(load), g1));
}

__device__ __forceinline__ double penalty_f64(double load, double ag, double g1) {
  return __dmul_rn(ag, torch_pow_f64(clamp0(load), g1));
}

// Whether (a, ia) comes before (b, ib) in torch.argmax's order (kMax) or
// torch.argmin's: NaN first, then the larger (smaller) value, then the lower
// index; INT_MAX marks an empty candidate.
template <bool kMax, typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  if (ia == INT_MAX) return false;
  if (ib == INT_MAX) return true;
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  if (a == b) return ia < ib;
  return kMax ? a > b : a < b;
}

// The warp's first argmax (kMax) or argmin of (v, i) pairs; every lane
// gets the result.
template <bool kMax, typename T>
__device__ __forceinline__ void warp_arg(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (before<kMax>(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Float keys whose unsigned order is the float order (NaN excluded; -0 is
// first made +0, which torch's compares treat as equal).
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(__fadd_rn(x, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// First argmax (kMax) or argmin over lanes with a bit in `valid`, one
// value a lane, lane = index: a redux over keys, then a ballot for the
// lowest lane that holds the extreme.  Key 0 is below every real key.
template <bool kMax>
__device__ __forceinline__ int lanes_first_arg(float x, unsigned valid) {
  const int lane = threadIdx.x & 31;
  const bool mine = (valid >> lane) & 1u;
  const unsigned nan = __ballot_sync(kFull, mine && isnan(x));
  if (nan) return __ffs(nan) - 1;
  const unsigned key = mine ? (kMax ? order_key(x) : ~order_key(x)) : 0u;
  const unsigned top = __reduce_max_sync(kFull, key);
  return __ffs(__ballot_sync(kFull, mine && key == top)) - 1;
}

// The float64 form: a butterfly of fmax (fmin), then the ballot.
template <bool kMax>
__device__ __forceinline__ int lanes_first_arg(double x, unsigned valid) {
  const int lane = threadIdx.x & 31;
  const bool mine = (valid >> lane) & 1u;
  const unsigned nan = __ballot_sync(kFull, mine && isnan(x));
  if (nan) return __ffs(nan) - 1;
  double m = mine ? x : (kMax ? -INFINITY : INFINITY);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double o = __shfl_xor_sync(kFull, m, off);
    m = kMax ? fmax(m, o) : fmin(m, o);
  }
  return __ffs(__ballot_sync(kFull, mine && x == m)) - 1;
}

__device__ __forceinline__ void cp_async16(void* dst_smem, const void* src_gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src_gmem));
}

template <int kBytes>
__device__ __forceinline__ void cp_async_small(void* dst_smem, const void* src_gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src_gmem),
               "n"(kBytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Raises `kernel`'s dynamic shared memory to `bytes` on the current device,
// once per device (`granted` remembers it); kErrSharedMemory when `bytes`
// plus the kernel's static `fixed` bytes do not fit a block.
template <typename Kernel>
int reserve_shared(Kernel kernel, long long bytes, long long fixed, long long* granted,
                   int* device_out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *device_out = device;
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

int optin_bytes(int* limit) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return static_cast<int>(err);
}

// --------------------------------------------------------- fennel_gain

constexpr int kGainWarps = 8;
constexpr int kGainThreads = 32 * kGainWarps;
constexpr long long kMaxGeneralBlocks = 1024;
// the fast kernel: kLanes lanes own a row, so a warp compares kRows rows at
// once (its stage), each lane holding kPerLane blocks
constexpr int kLanes = 4;
constexpr int kRows = 32 / kLanes;
constexpr int kPerLane = 32 / kLanes;
constexpr int kStages = 3;
constexpr int kFastBlocksPerSm = 2;

// A staged row takes W + 4 words, so that the rows a warp reads at once
// start in different 16-byte bank groups.
__host__ __device__ constexpr long long fast_row_words(long long width) { return width + 4; }

// One warp's stage: its rows' labels and weights, and their node weights.
__host__ __device__ constexpr long long fast_stage_words(long long width) {
  return 2 * kRows * fast_row_words(width) + kRows;
}

__host__ __device__ constexpr long long fast_block_bytes(long long width) {
  return 4LL * kGainWarps * kStages * fast_stage_words(width);
}

__global__ void __launch_bounds__(kGainThreads, kFastBlocksPerSm)
fennel_gain_fast(const int32_t* __restrict__ nbr_blk, const float* __restrict__ nbr_w,
                 const float* __restrict__ loads, const float* __restrict__ node_w,
                 int32_t* __restrict__ best_out, float* __restrict__ score_out, long long rows,
                 long long share, int width, int k, float cap, float ag, double g1) {
  extern __shared__ __align__(16) int32_t ring[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = lane / kLanes;  // the warp's row this lane works on
  const int sub = lane % kLanes;
  // the warp's contiguous share of the rows, staged kRows at a time into its
  // own ring: no block-wide barrier, so a warp starts as soon as its own
  // rows have landed
  const long long lo = (static_cast<long long>(blockIdx.x) * kGainWarps + warp) * share;
  const long long hi = lo + share < rows ? lo + share : rows;
  const int passes = hi > lo ? static_cast<int>((hi - lo + kRows - 1) / kRows) : 0;
  const long long stage_words = fast_stage_words(width);
  const int stride = static_cast<int>(fast_row_words(width));
  const int row_vecs = width / 4;
  int32_t* own = ring + warp * kStages * stage_words;

  auto issue = [&](int pass, int stage) {
    if (pass < passes) {
      const long long r0 = lo + static_cast<long long>(pass) * kRows;
      const int nr = static_cast<int>(hi - r0 < kRows ? hi - r0 : kRows);
      int32_t* lab = own + stage * stage_words;
      float* wt = reinterpret_cast<float*>(lab + kRows * stride);
      const int32_t* src_l = nbr_blk + r0 * width;
      const float* src_w = nbr_w + r0 * width;
      int r = lane / row_vecs, c = lane - r * row_vecs;
      for (int i = lane; i < nr * row_vecs; i += 32) {  // 16 bytes a lane
        cp_async16(lab + r * stride + 4 * c, src_l + 4 * i);
        cp_async16(wt + r * stride + 4 * c, src_w + 4 * i);
        for (c += 32; c >= row_vecs; c -= row_vecs) ++r;
      }
      if (lane < nr) cp_async_small<4>(wt + kRows * stride + lane, node_w + r0 + lane);
    }
    cp_async_commit();  // an empty group keeps the ring's group count in step
  };

  // lane i reads block i's load ahead of the first copies and computes its
  // penalty while those are in flight; then each lane takes its blocks
  // sub + kLanes*j (loads and penalties) into registers
  const float own_load = lane < k ? loads[lane] : 0.0f;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) issue(p, p);
  const float own_pen = lane < k ? penalty_f32(own_load, ag, g1) : 0.0f;
  const int fallback = lanes_first_arg<false>(own_load, k >= 32 ? kFull : (1u << k) - 1u);
  float ld[kPerLane], pen[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    ld[j] = __shfl_sync(kFull, own_load, sub + kLanes * j);
    pen[j] = __shfl_sync(kFull, own_pen, sub + kLanes * j);
  }

  for (int p = 0; p < passes; ++p) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // pass p has landed for every lane, and pass p - 1's stage is free
    issue(p + kStages - 1, (p + kStages - 1) % kStages);

    const long long r0 = lo + static_cast<long long>(p) * kRows;
    const int nr = static_cast<int>(hi - r0 < kRows ? hi - r0 : kRows);
    const int32_t* lab = own + (p % kStages) * stage_words;
    const float* wt = reinterpret_cast<const float*>(lab + kRows * stride);
    // past nr the row holds stale data and is never written
    const int4* l4 = reinterpret_cast<const int4*>(lab + part * stride);
    const float4* w4 = reinterpret_cast<const float4*>(wt + part * stride);
    float acc[kPerLane] = {};
#pragma unroll 2
    for (int g = 0; g < row_vecs; ++g) {
      const int4 l = l4[g];  // one address for the row's kLanes lanes: a broadcast
      const float4 w = w4[g];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {  // a compare and a predicated add each
        const int b = sub + kLanes * j;
        if (l.x == b) acc[j] = __fadd_rn(acc[j], w.x);
        if (l.y == b) acc[j] = __fadd_rn(acc[j], w.y);
        if (l.z == b) acc[j] = __fadd_rn(acc[j], w.z);
        if (l.w == b) acc[j] = __fadd_rn(acc[j], w.w);
      }
    }
    // the row's first argmax: the lane's first largest key over its blocks
    // (ascending), then the largest key among the row's lanes and the lowest
    // block that holds it; NaN keys above all, as torch.argmax takes NaN
    const float nwr = wt[kRows * stride + part];
    unsigned top = 0;  // below every real key
    int arg = INT_MAX;
    float val = -INFINITY;
    bool ok_any = false;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int b = sub + kLanes * j;
      if (b < k) {
        const bool ok = __fadd_rn(ld[j], nwr) <= cap;
        const float s = ok ? __fsub_rn(acc[j], pen[j]) : -INFINITY;
        const unsigned kj = isnan(s) ? 0xffffffffu : order_key(s);
        ok_any |= ok;
        if (kj > top) {
          top = kj;
          arg = b;
          val = s;
        }
      }
    }
    unsigned row_top = top;
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      row_top = max(row_top, __shfl_xor_sync(kFull, row_top, off));
    int first = top == row_top ? arg : INT_MAX;
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      first = min(first, __shfl_xor_sync(kFull, first, off));
    // the value, from the lane that holds block `first` (the sign of a zero kept)
    const float best_val = __shfl_sync(kFull, val, part * kLanes + first % kLanes);
    const unsigned feasible = __ballot_sync(kFull, ok_any) >> (part * kLanes);
    if (sub == 0 && part < nr) {
      const bool any = (feasible & ((1u << kLanes) - 1u)) != 0;
      best_out[r0 + part] = any ? first : fallback;
      score_out[r0 + part] = any ? best_val : -INFINITY;
    }
  }
  cp_async_wait<0>();
}

// kRowShared: loads and penalty staged in shared memory (8*k bytes).
// Otherwise (a k whose row does not fit) each lane reads its candidate
// block's load from device memory and computes the penalty itself, with
// the same penalty_f32, so both forms give the same bits.
template <bool kRowShared>
__global__ void __launch_bounds__(kGainThreads)
fennel_gain_general(const int32_t* __restrict__ nbr_blk, const float* __restrict__ nbr_w,
                    const float* __restrict__ loads, const float* __restrict__ node_w,
                    int32_t* __restrict__ best_out, float* __restrict__ score_out,
                    long long rows, long long width, int k, float cap, float ag, double g1) {
  extern __shared__ float row[];  // kRowShared: loads[0, k), penalty[k, 2k)
  __shared__ int fallback_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (kRowShared) {
    for (int i = threadIdx.x; i < k; i += kGainThreads) {
      const float ld = loads[i];
      row[i] = ld;
      row[k + i] = penalty_f32(ld, ag, g1);
    }
  }
  if (warp == 0) {  // the first least-loaded block, by one warp
    float v = 0.0f;
    int vi = INT_MAX;
    for (int i = lane; i < k; i += 32) {
      const float ld = loads[i];
      if (before<false>(ld, i, v, vi)) {
        v = ld;
        vi = i;
      }
    }
    warp_arg<false>(v, vi);
    if (lane == 0) fallback_s = vi;
  }
  __syncthreads();
  const int fallback = fallback_s;

  for (long long r = static_cast<long long>(blockIdx.x) * kGainWarps + warp; r < rows;
       r += static_cast<long long>(gridDim.x) * kGainWarps) {
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
        const float ld = kRowShared ? row[label] : __ldg(loads + label);
        const bool ok = __fadd_rn(ld, nw) <= cap;
        const float pen = kRowShared ? row[k + label] : penalty_f32(ld, ag, g1);
        const float s = ok ? __fsub_rn(acc, pen) : -INFINITY;
        feasible |= ok;
        if (before<true>(s, label, best_v, best_i)) {
          best_v = s;
          best_i = label;
        }
      }
    }
    warp_arg<true>(best_v, best_i);
    const bool any_ok = __any_sync(kFull, feasible);
    if (lane == 0) {
      best_out[r] = any_ok ? best_i : fallback;
      score_out[r] = any_ok ? best_v : -INFINITY;
    }
  }
}

// --------------------------------------------------------- fennel_sweep

constexpr int kSweepThreads = 256;  // warp 0 decides, warp 1 stages, all copy labels
constexpr int kRing = 4096;         // staged segment entries (dst, weight)
constexpr int kDirect = 1024;       // a longer segment is read from device memory
constexpr int kMeta = 256;          // staged steps
constexpr long long kSweepBaseBytes = 16LL * kRing + 32LL * kMeta;

struct SweepArgs {
  const long long* edst;
  const double* ew;
  const double* node_w;
  const long long* order;
  const long long* indptr;
  long long* labels;
  double* loads;
  double* scratch;  // 3k doubles: loads, penalty, sums, when they are not in shared memory
  long long n_pad;
  int n_free;
  int k;
  double ag;
  double g1;
  double cap;
  int k_shared;  // 1 when the 3k doubles are in shared memory
};

struct SweepRing {
  long long* dst;
  double* w;
  long long* v;
  long long* a;
  double* nw;
  unsigned* pos;
  int* len;
};

struct SweepSync {
  volatile int produced;   // steps staged
  volatile int consumed;   // steps decided
  volatile unsigned consumed_pos;  // ring entries released
};

// Warp 1: stage 32 steps at a time (metadata, then their segments).
__device__ void sweep_stage(const SweepArgs p, const SweepRing r, SweepSync& sync) {
  const int lane = threadIdx.x & 31;
  int s0 = 0;
  unsigned ppos = 0;
  while (s0 < p.n_free) {
    const int s = s0 + lane;
    long long v = 0, a = 0;
    int len = 0;
    double nw = 0.0;
    if (s < p.n_free) {
      v = p.order[s];
      a = p.indptr[v];
      len = static_cast<int>(p.indptr[v + 1] - a);
      nw = p.node_w[v];
    }
    const int staged = len <= kDirect ? len : 0;
    int incl = staged;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    const int excl = incl - staged;
    // a prefix of the lanes: every step fits half the ring, so lane 0 does
    const int steps = __popc(__ballot_sync(kFull, s < p.n_free && incl <= kRing / 2));
    const int entries = __shfl_sync(kFull, incl, steps - 1);
    if (lane == 0) {
      while (s0 + steps - sync.consumed > kMeta ||
             ppos + entries - sync.consumed_pos > static_cast<unsigned>(kRing)) {
        __nanosleep(64);
      }
      __threadfence_block();
    }
    __syncwarp();
    if (lane < steps) {
      const int slot = (s0 + lane) & (kMeta - 1);
      r.v[slot] = v;
      r.a[slot] = a;
      r.nw[slot] = nw;
      r.len[slot] = len;
      r.pos[slot] = ppos + excl;
    }
    for (int j = 0; j < steps; ++j) {
      const int lj = __shfl_sync(kFull, staged, j);
      const long long aj = __shfl_sync(kFull, a, j);
      const unsigned pj = ppos + __shfl_sync(kFull, excl, j);
      for (int e = lane; e < lj; e += 32) {
        const unsigned slot = (pj + e) & (kRing - 1);
        cp_async_small<8>(r.dst + slot, p.edst + aj + e);
        cp_async_small<8>(r.w + slot, p.ew + aj + e);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __threadfence_block();
    __syncwarp();
    if (lane == 0) sync.produced = s0 + steps;
    s0 += steps;
    ppos += entries;
  }
}

// The label of neighbour d, or -1 for padding and unlabelled nodes.
template <bool kLabelsShared>
__device__ __forceinline__ int sweep_label(const SweepArgs& p, const int32_t* lab_s,
                                           long long d) {
  if (d < 0 || d >= p.n_pad) return -1;
  return kLabelsShared ? lab_s[d] : static_cast<int>(p.labels[d]);
}

// Warp 0: n_free dependent decisions.  kLanesK: lane b holds block b's load,
// penalty and sum in registers (k <= 32); otherwise `karr` holds them, lane
// b % 32 owning block b.
template <bool kLabelsShared, bool kLanesK>
__device__ void sweep_decide(const SweepArgs p, const SweepRing r, SweepSync& sync,
                             int32_t* lab_s, double* karr) {
  const int lane = threadIdx.x & 31;
  const int k = p.k;
  const unsigned valid = k >= 32 ? kFull : (1u << k) - 1u;
  const bool mine = lane < k;
  double ld = 0.0, pen = 0.0;
  if (kLanesK && mine) {
    ld = p.loads[lane];
    pen = penalty_f64(ld, p.ag, p.g1);
  }
  double* kload = karr;
  double* kpen = karr + k;
  double* kconn = karr + 2 * k;
  int avail = 0;
  for (int i = 0; i < p.n_free; ++i) {
    if (i >= avail) {
      int got = 0;
      if (lane == 0) {
        while ((got = sync.produced) <= i) {
        }
        __threadfence_block();
      }
      avail = __shfl_sync(kFull, got, 0);
      __syncwarp();
    }
    const int slot = i & (kMeta - 1);
    const long long v = r.v[slot], a = r.a[slot];
    const double nw = r.nw[slot];
    const unsigned pos = r.pos[slot];
    const int len = r.len[slot];
    const bool staged = len <= kDirect;

    // connection sums, in segment order
    double acc = 0.0;
    for (int c = 0; c < len; c += 32) {
      const int e = c + lane;
      int lab = -1;
      double w = 0.0;
      if (e < len) {
        long long d;
        if (staged) {
          const unsigned sl = (pos + e) & (kRing - 1);
          d = r.dst[sl];
          w = r.w[sl];
        } else {
          d = p.edst[a + e];
          w = p.ew[a + e];
        }
        lab = sweep_label<kLabelsShared>(p, lab_s, d);
      }
      unsigned hits = __ballot_sync(kFull, lab >= 0 && lab < k);
      while (hits) {  // ascending entries: the segment's order
        const int t = __ffs(hits) - 1;
        hits &= hits - 1;
        const int lt = __shfl_sync(kFull, lab, t);
        const double wt = __shfl_sync(kFull, w, t);
        if (kLanesK) {
          if (lt == lane) acc = __dadd_rn(acc, wt);
        } else if ((lt & 31) == lane) {
          kconn[lt] = __dadd_rn(kconn[lt], wt);
        }
      }
    }

    // the decision
    int best;
    if (kLanesK) {
      const bool ok = mine && __dadd_rn(ld, nw) <= p.cap;
      const double s = ok ? __dsub_rn(acc, pen) : -INFINITY;
      best = __any_sync(kFull, ok) ? lanes_first_arg<true>(s, valid)
                                   : lanes_first_arg<false>(ld, valid);
      if (lane == best) {
        ld = __dadd_rn(ld, nw);
        pen = penalty_f64(ld, p.ag, p.g1);
      }
    } else {
      double bv = 0.0, mv = 0.0;
      int bi = INT_MAX, mi = INT_MAX;
      bool feasible = false;
      for (int b = lane; b < k; b += 32) {
        const double lb = kload[b];
        const bool ok = __dadd_rn(lb, nw) <= p.cap;
        const double s = ok ? __dsub_rn(kconn[b], kpen[b]) : -INFINITY;
        kconn[b] = 0.0;
        feasible |= ok;
        if (before<true>(s, b, bv, bi)) {
          bv = s;
          bi = b;
        }
        if (before<false>(lb, b, mv, mi)) {
          mv = lb;
          mi = b;
        }
      }
      if (__any_sync(kFull, feasible)) {
        warp_arg<true>(bv, bi);
        best = bi;
      } else {
        warp_arg<false>(mv, mi);
        best = mi;
      }
      if ((best & 31) == lane) {
        const double nl = __dadd_rn(kload[best], nw);
        kload[best] = nl;
        kpen[best] = penalty_f64(nl, p.ag, p.g1);
      }
    }
    if (lane == 0) {
      if (kLabelsShared) {
        lab_s[v] = best;
      } else {
        p.labels[v] = best;
      }
    }
    __syncwarp();  // the label is visible to the warp's next reads
    if (lane == 0) {
      __threadfence_block();
      sync.consumed = i + 1;
      sync.consumed_pos = pos + (staged ? static_cast<unsigned>(len) : 0u);
    }
  }
  if (kLanesK && mine) p.loads[lane] = ld;
}

template <bool kLabelsShared, bool kLanesK>
__global__ void __launch_bounds__(kSweepThreads, 1) fennel_sweep_kernel(SweepArgs p) {
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  __shared__ SweepSync sync;
  SweepRing r;
  r.dst = reinterpret_cast<long long*>(sweep_smem);
  r.w = reinterpret_cast<double*>(r.dst + kRing);
  r.v = reinterpret_cast<long long*>(r.w + kRing);
  r.a = r.v + kMeta;
  r.nw = reinterpret_cast<double*>(r.a + kMeta);
  r.pos = reinterpret_cast<unsigned*>(r.nw + kMeta);
  r.len = reinterpret_cast<int*>(r.pos + kMeta);
  unsigned char* tail = sweep_smem + kSweepBaseBytes;
  double* karr = p.k_shared ? reinterpret_cast<double*>(tail) : p.scratch;
  int32_t* lab_s = reinterpret_cast<int32_t*>(tail + (p.k_shared ? 24LL * p.k : 0));

  if (threadIdx.x == 0) {
    sync.produced = 0;
    sync.consumed = 0;
    sync.consumed_pos = 0;
  }
  if (kLabelsShared) {
#pragma unroll 8
    for (long long i = threadIdx.x; i < p.n_pad; i += kSweepThreads)
      lab_s[i] = static_cast<int32_t>(p.labels[i]);
  }
  if (!kLanesK) {
    for (int b = threadIdx.x; b < p.k; b += kSweepThreads) {
      const double ld = p.loads[b];
      karr[b] = ld;
      karr[p.k + b] = penalty_f64(ld, p.ag, p.g1);
      karr[2 * p.k + b] = 0.0;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    sweep_decide<kLabelsShared, kLanesK>(p, r, sync, lab_s, karr);
  } else if (warp == 1) {
    sweep_stage(p, r, sync);
  }
  __syncthreads();
  if (kLabelsShared) {
    for (long long i = threadIdx.x; i < p.n_pad; i += kSweepThreads) p.labels[i] = lab_s[i];
  }
  if (!kLanesK) {
    for (int b = threadIdx.x; b < p.k; b += kSweepThreads) p.loads[b] = karr[b];
  }
}

template <bool kLabelsShared, bool kLanesK>
int launch_sweep(const SweepArgs& p, long long bytes, cudaStream_t stream) {
  static long long granted[kMaxDevices] = {};
  int device = 0;
  const int err = reserve_shared(fennel_sweep_kernel<kLabelsShared, kLanesK>, bytes,
                                 static_cast<long long>(sizeof(SweepSync)), granted, &device);
  if (err != 0) return err;
  fennel_sweep_kernel<kLabelsShared, kLanesK>
      <<<1, kSweepThreads, static_cast<size_t>(bytes), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_fast(const int32_t* blk, const float* wts, const float* ld, const float* nw,
                int32_t* best_out, float* score_out, long long rows, long long width, int k,
                float cap, float ag, double g1, cudaStream_t stream) {
  static long long granted[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  static int per_sm[kMaxDevices] = {};
  static long long per_sm_bytes[kMaxDevices] = {};
  const long long bytes = fast_block_bytes(width);
  int device = 0;
  int err = reserve_shared(fennel_gain_fast, bytes, 0, granted, &device);
  if (err != 0) return err;
  // SMs and blocks a SM at this ring size, cached per device and size
  const bool known = device < kMaxDevices;
  int count = known ? sms[device] : 0, blocks = known ? per_sm[device] : 0;
  if (!known || count == 0 || per_sm_bytes[device] != bytes) {
    cudaError_t e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fennel_gain_fast, kGainThreads,
                                                        static_cast<size_t>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (known) {
      sms[device] = count;
      per_sm[device] = blocks;
      per_sm_bytes[device] = bytes;
    }
  }
  // a persistent grid; each warp takes a contiguous share of the rows, and
  // no more blocks than the rows fill with one stage a warp
  const long long fill = (rows + kGainWarps * kRows - 1) / (kGainWarps * kRows);
  const long long resident = static_cast<long long>(count) * (blocks > 0 ? blocks : 1);
  const dim3 grid(static_cast<unsigned>(fill < resident ? fill : resident));
  const long long warps = static_cast<long long>(grid.x) * kGainWarps;
  const long long share = (rows + warps - 1) / warps;
  fennel_gain_fast<<<grid, kGainThreads, static_cast<size_t>(bytes), stream>>>(
      blk, wts, ld, nw, best_out, score_out, rows, share, static_cast<int>(width), k, cap, ag,
      g1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream` on
// the current device, does not synchronise, and returns cudaGetLastError(),
// -1 when what must sit in shared memory does not fit a block, or -2 for a
// shape it does not take.

// The public op.  `cap` is float32; `ag` = alpha * gamma and `g1` = gamma -
// 1 as doubles (the kernel rounds ag to float32, as torch.mul does).
extern "C" int fennel_gain_launch(const void* nbr_blk, const void* nbr_w, const void* loads,
                                  const void* node_w, void* best, void* score, long long rows,
                                  long long width, int k, float cap, double ag, double g1,
                                  void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const auto* blk = static_cast<const int32_t*>(nbr_blk);
  const auto* wts = static_cast<const float*>(nbr_w);
  const auto* ld = static_cast<const float*>(loads);
  const auto* nw = static_cast<const float*>(node_w);
  auto* best_out = static_cast<int32_t*>(best);
  auto* score_out = static_cast<float*>(score);
  const float agf = static_cast<float>(ag);  // round to nearest, as torch's scalar cast
  const auto s = static_cast<cudaStream_t>(stream);
  int limit = 0;
  int err = optin_bytes(&limit);
  if (err != 0) return err;
  if (k <= 32 && width > 0 && width % 4 == 0 && reinterpret_cast<uintptr_t>(nbr_blk) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(nbr_w) % 16 == 0 && fast_block_bytes(width) <= limit) {
    return launch_fast(blk, wts, ld, nw, best_out, score_out, rows, width, k, cap, agf, g1, s);
  }
  const long long blocks = (rows + kGainWarps - 1) / kGainWarps;
  const dim3 grid(static_cast<unsigned>(blocks < kMaxGeneralBlocks ? blocks : kMaxGeneralBlocks));
  const long long bytes = 2 * sizeof(float) * static_cast<long long>(k);
  if (bytes + static_cast<long long>(sizeof(int)) > limit) {  // the row stays in device memory
    fennel_gain_general<false><<<grid, kGainThreads, 0, s>>>(blk, wts, ld, nw, best_out,
                                                             score_out, rows, width, k, cap,
                                                             agf, g1);
    return static_cast<int>(cudaGetLastError());
  }
  static long long granted[kMaxDevices] = {};
  int device = 0;
  err = reserve_shared(fennel_gain_general<true>, bytes, static_cast<long long>(sizeof(int)),
                       granted, &device);
  if (err != 0) return err;
  fennel_gain_general<true><<<grid, kGainThreads, static_cast<size_t>(bytes), s>>>(
      blk, wts, ld, nw, best_out, score_out, rows, width, k, cap, agf, g1);
  return static_cast<int>(cudaGetLastError());
}

// The sweep, in place on `labels` (int64, n_pad) and `loads` (float64, k).
// `indptr` has n_pad + 1 entries; `scratch` holds 3k doubles.  The edge
// arrays are sorted by source, so v's segment is [indptr[v], indptr[v+1]).
extern "C" int fennel_sweep_launch(const void* edst, const void* ew, const void* node_w,
                                   const void* order, const void* indptr, void* labels,
                                   void* loads, void* scratch, long long n_pad, long long n_free,
                                   int k, double ag, double g1, double cap, void* stream) {
  if (n_free <= 0) return static_cast<int>(cudaSuccess);
  if (n_free > INT_MAX || k <= 0) return kErrShape;
  int limit = 0;
  const int err = optin_bytes(&limit);
  if (err != 0) return err;
  const long long room = limit - static_cast<long long>(sizeof(SweepSync)) - kSweepBaseBytes;
  if (room < 0) return kErrSharedMemory;
  const bool lanes_k = k <= 32;
  const bool labels_shared = 4 * n_pad <= room;
  const long long left = room - (labels_shared ? 4 * n_pad : 0);
  const bool k_shared = !lanes_k && 24LL * k <= left;
  const long long bytes =
      kSweepBaseBytes + (labels_shared ? 4 * n_pad : 0) + (k_shared ? 24LL * k : 0);
  SweepArgs p{static_cast<const long long*>(edst), static_cast<const double*>(ew),
              static_cast<const double*>(node_w), static_cast<const long long*>(order),
              static_cast<const long long*>(indptr), static_cast<long long*>(labels),
              static_cast<double*>(loads), static_cast<double*>(scratch), n_pad,
              static_cast<int>(n_free), k, ag, g1, cap, k_shared ? 1 : 0};
  const auto s = static_cast<cudaStream_t>(stream);
  if (labels_shared) {
    return lanes_k ? launch_sweep<true, true>(p, bytes, s) : launch_sweep<true, false>(p, bytes, s);
  }
  return lanes_k ? launch_sweep<false, true>(p, bytes, s) : launch_sweep<false, false>(p, bytes, s);
}
