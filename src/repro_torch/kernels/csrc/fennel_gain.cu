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
// next, and one block's load changes), so the sweep is one block and its
// time is the dependent chain; its bytes (the segments, order, indptr,
// labels) are small.  Warp 1 stages; warp 0 decides.
//   - Staging.  Segments, order and indptr do not depend on decisions, so
//     warp 1 reads 32 steps at a time, lane s taking step s: its metadata
//     and, for a segment of at most 8 entries (kSlots; a mesh's coarsest
//     level has ~6), its entries, which it stages into a ring of 4096 as
//     (4 * neighbour id, weight), padded to 8 and aligned, with the step's
//     flags and the summed weight of its entries to the node of the step
//     before, whose label the stager leaves out (that node is decided one
//     step before this one reads).  The warp stages a longer segment
//     together; one past 1024 entries (an R-MAT hub) is read from device
//     memory when its step comes.  Counters in shared memory pass batches
//     one way and released space (every 32 steps) the other.
//   - Deciding, k <= 32 (the main path).  Lane b holds block b's load and
//     penalty in registers and, for the coming step, two scores: for "block
//     b did not take the step before" and for "it did" (its load and
//     penalty after that step, and its sum with the weight to that step's
//     node added).  A step's chain is then only: compare the lane with the
//     step before's choice and select a score key's high word, two reduxes
//     of its top 27 bits with the lane below them (the larger lane and the
//     complement, so the maximum and the lowest and highest lanes holding
//     it come out together), and read the lowest lane.  Everything else is
//     issued beside that chain: the next step's sums (its labels were read
//     when the step before was stored, so only that step's node is missing,
//     and the second score carries it), feasibility, penalty (sqrt at gamma
//     = 1.5) and scores, and the metadata and 8 staged entries of the step
//     after it, into registers.  Keys are 64-bit order-preserving images of
//     the float64 scores (NaN largest, infeasible at -inf, -0 as +0), so the
//     first maximum is torch.argmax's.  A step whose top bits tie across
//     lanes, or where no score is above -inf, settles on the full keys in a
//     branch (a ballot for "some block is feasible", then the first argmax,
//     or the first least-loaded block); that branch, the ordered sums below
//     and the staging handshake are one rare branch after the chain.  Each
//     warp-wide collective costs the loop far more than its own latency
//     (the code around it cannot be scheduled across it), so the main path
//     holds one: the two reduxes.
//   - Exactness.  A segment whose weights are all integers with magnitudes
//     summing below 2^53 adds exactly in any order, so its sums run in two
//     chains and its "took the step before" sum is the other plus the
//     staged weight to that node, one add.  Any other segment (fractional
//     weights, or more than 8 entries) is summed in segment order, the
//     entries to that node counted in the second sum, in the rare branch.
//     So every sum has the bits of the segment-order sum that the host
//     engines form.
//   - Deciding, k > 32: `karr` (shared memory, or device memory when 24*k
//     bytes do not fit) holds loads, penalties and sums, lane b % 32 owning
//     block b; a step reads its labels after the step before is decided and
//     adds its hits one at a time.
//   - Labels live in shared memory as int32 where n_pad + 1 of them fit
//     beside the ring (n_pad <= ~42k), else in device memory; every lane
//     stores each decided label, so each sees it in its own later reads.
// Every step of the decision is a single float64 operation (__dadd_rn,
// __dsub_rn, __dmul_rn, __dsqrt_rn), the plain version's, and ties break to
// the lowest block as torch.argmax and torch.argmin do.
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
constexpr int kRing = 4096;         // staged segment entries
constexpr int kSlots = 8;           // entries a step's fast path reads, whatever its length
constexpr int kDirect = 1024;       // a longer segment is read from device memory
constexpr int kMeta = 256;          // staged steps
constexpr int kReleaseEvery = 32;   // steps between releases of staged space
constexpr int kStamps = 19;         // counters of the stamped instantiation (STAMP_KEYS)
constexpr int kChainReps = 4096;    // its chain probe's iterations
constexpr long long kSweepBaseBytes =  // metaw, ring weights, refs, meta, meta_a, ring prev
    16LL * kMeta + 8LL * kRing + 4LL * kRing + 16LL * kMeta + 8LL * kMeta + kRing;
constexpr double kExactSum = 9007199254740992.0;  // 2^53
constexpr int kFast = 1;     // SweepMeta::flags: the step's sums are exact in any order
constexpr int kHasPrev = 2;  // its segment holds the node of the step before

struct __align__(16) SweepMeta {
  int v;
  unsigned pos;  // the step's first ring entry (a running count, a multiple of kSlots)
  int len;       // its segment's entries
  int flags;
};

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
  int ref_none;  // 4 * n_pad
  int n_free;
  int k;
  double ag;
  double g1;
  double cap;
  int k_shared;  // 1 when the 3k doubles are in shared memory
};

// The staged steps.  A ring entry is (ref, prev, w): ref is 4 * the
// neighbour's id (a byte offset into the labels in shared memory), or
// ref_none (a slot that holds -1) for padding and for the node of the
// step before, which prev marks.  A step's entries start at a multiple of
// kSlots; a short segment is padded to kSlots.
struct SweepShared {
  double2* metaw;  // (node weight, weight of the entries to the node of the step before)
  double* ring_w;
  int* ring_ref;
  SweepMeta* meta;
  long long* meta_a;  // segment start, for a segment read from device memory
  unsigned char* ring_prev;
};

struct SweepSync {
  volatile int produced;   // steps staged
  volatile int consumed;   // steps whose staged data may be overwritten
  volatile unsigned consumed_pos;  // ring entries released
};

// Ring entries a step takes: a segment of at most kDirect entries rounded
// up to kSlots; a longer one is not staged.
__device__ __forceinline__ int footprint(int len) {
  return len > kDirect ? 0 : ((len > kSlots ? len : kSlots) + kSlots - 1) / kSlots * kSlots;
}

// The ring's ref of neighbour d seen from a step whose previous node is vprev.
__device__ __forceinline__ int entry_ref(const SweepArgs& p, long long d, long long vprev) {
  return (d >= 0 && d < p.n_pad && d != vprev) ? static_cast<int>(4 * d) : p.ref_none;
}

__device__ __forceinline__ void put_entry(const SweepShared& r, unsigned at, int ref, bool prev,
                                          double w) {
  const unsigned slot = at & (kRing - 1);
  r.ring_ref[slot] = ref;
  r.ring_prev[slot] = prev;
  r.ring_w[slot] = w;
}

// Warp 1: stage 32 steps at a time.  Lane s reads step s's metadata and,
// for a segment of at most kSlots entries, its entries, which it stages
// padded to kSlots with the step's flags: whether an entry is the node of
// the step before, whether its sums are exact in any order.  The warp
// stages a longer segment together.
template <bool kStamp>
__device__ void sweep_stage(const SweepArgs p, const SweepShared r, SweepSync& sync,
                            long long* stamps) {
  const int lane = threadIdx.x & 31;
  long long busy = 0, batches = 0, t_a = kStamp ? clock64() : 0;
  int s0 = 0;
  unsigned ppos = 0;
  while (s0 < p.n_free) {
    const int s = s0 + lane;
    const bool live = s < p.n_free;
    long long v = 0, a = 0, vprev = -1;
    int len = 0;
    double nw = 0.0;
    if (live) {
      v = p.order[s];
      a = p.indptr[v];
      len = static_cast<int>(p.indptr[v + 1] - a);
      nw = p.node_w[v];
      if (s > 0) vprev = p.order[s - 1];
    }
    const int fp = live ? footprint(len) : 0;
    int incl = fp;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    // a prefix of the lanes: every step fits half the ring, so lane 0 does
    const int steps = __popc(__ballot_sync(kFull, live && incl <= kRing / 2));
    const int entries = __shfl_sync(kFull, incl, steps - 1);
    const bool mine = lane < steps;
    const bool short_seg = mine && len <= kSlots;
    // a short segment's entries, all loads at once
    long long d[kSlots];
    double w[kSlots];
#pragma unroll
    for (int e = 0; e < kSlots; ++e) {
      d[e] = -1;
      w[e] = 0.0;
      if (short_seg && e < len) {
        d[e] = p.edst[a + e];
        w[e] = p.ew[a + e];
      }
    }
    if (kStamp) busy += clock64() - t_a;
    if (lane == 0) {
      while (s0 + steps - sync.consumed > kMeta ||
             ppos + entries - sync.consumed_pos > static_cast<unsigned>(kRing)) {
        __nanosleep(64);
      }
      __threadfence_block();
    }
    __syncwarp();
    if (kStamp) t_a = clock64();
    const unsigned pos = ppos + incl - fp;
    int flags = 0;
    double wprev = 0.0;
    if (short_seg) {
      bool has_prev = false, integral = true;
      double total = 0.0;
      int ref[kSlots];
      unsigned long long prev_bytes = 0;
#pragma unroll
      for (int e = 0; e < kSlots; ++e) {
        const bool prev = e < len && d[e] == vprev;
        ref[e] = e < len ? entry_ref(p, d[e], vprev) : p.ref_none;
        prev_bytes |= static_cast<unsigned long long>(prev) << (8 * e);
        has_prev |= prev;
        if (prev) wprev = __dadd_rn(wprev, w[e]);
        integral &= w[e] == trunc(w[e]);
        total = __dadd_rn(total, fabs(w[e]));
      }
      const unsigned slot = pos & (kRing - 1);
      int4* rr = reinterpret_cast<int4*>(r.ring_ref + slot);
      rr[0] = make_int4(ref[0], ref[1], ref[2], ref[3]);
      rr[1] = make_int4(ref[4], ref[5], ref[6], ref[7]);
      double2* rw = reinterpret_cast<double2*>(r.ring_w + slot);
#pragma unroll
      for (int e = 0; e < kSlots / 2; ++e) rw[e] = make_double2(w[2 * e], w[2 * e + 1]);
      *reinterpret_cast<unsigned long long*>(r.ring_prev + slot) = prev_bytes;
      // integers whose magnitudes sum below 2^53 add exactly in any order
      const bool exact = integral && total < kExactSum;
      flags = (has_prev ? kHasPrev : 0) | (exact ? kFast : 0);
    }
    unsigned longs = __ballot_sync(kFull, mine && len > kSlots && len <= kDirect);
    while (longs) {
      const int j = __ffs(longs) - 1;
      longs &= longs - 1;
      const int lj = __shfl_sync(kFull, len, j);
      const long long aj = __shfl_sync(kFull, a, j);
      const long long vj = __shfl_sync(kFull, vprev, j);
      const unsigned pj = __shfl_sync(kFull, pos, j);
      for (int e = lane; e < lj; e += 32) {
        const long long de = p.edst[aj + e];
        put_entry(r, pj + e, entry_ref(p, de, vj), de == vj, p.ew[aj + e]);
      }
    }
    if (mine) {
      const int slot = s & (kMeta - 1);
      r.meta[slot] = SweepMeta{static_cast<int>(v), pos, len, flags};
      r.metaw[slot] = make_double2(nw, wprev);
      r.meta_a[slot] = a;
    }
    __threadfence_block();
    __syncwarp();
    if (lane == 0) sync.produced = s0 + steps;
    s0 += steps;
    ppos += entries;
    ++batches;
  }
  if (kStamp && lane == 0) {
    stamps[17] = busy + clock64() - t_a;
    stamps[18] = batches;
  }
}

// The decision warp waits until more than `need` steps are staged; returns
// how many are.
__device__ __forceinline__ int wait_staged(SweepSync& sync, int need) {
  int got = 0;
  if ((threadIdx.x & 31) == 0) {
    while ((got = sync.produced) <= need) {
    }
    __threadfence_block();
  }
  got = __shfl_sync(kFull, got, 0);
  __syncwarp();
  return got;
}

// The decision warp gives back the staged data of the first `steps` steps
// (ring entries before `pos`).
__device__ __forceinline__ void release(SweepSync& sync, int steps, unsigned pos) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();
    sync.consumed = steps;
    sync.consumed_pos = pos;
  }
}

// The label at byte offset `ref` (4 * node id; ref_none holds -1).
template <bool kLabelsShared>
__device__ __forceinline__ int label_at(const SweepArgs& p, const int32_t* lab_s, int ref) {
  if (kLabelsShared)
    return *reinterpret_cast<const int32_t*>(reinterpret_cast<const char*>(lab_s) + ref);
  return ref < p.ref_none ? static_cast<int>(p.labels[ref >> 2]) : -1;
}

// Every lane stores the label, so that each sees it in its own later reads.
template <bool kLabelsShared>
__device__ __forceinline__ void set_label(const SweepArgs& p, int32_t* lab_s, int v, int b) {
  if (kLabelsShared) {
    lab_s[v] = b;
  } else {
    p.labels[v] = b;
  }
}

// The penalty of a load: kSqrt for gamma = 1.5 (the paper's), the
// exponent's case list otherwise; the same float64 operations either way.
template <bool kSqrt>
__device__ __forceinline__ double sweep_penalty(double load, double ag, double g1) {
  return kSqrt ? __dmul_rn(ag, __dsqrt_rn(clamp0(load))) : penalty_f64(load, ag, g1);
}

// Float64 keys whose unsigned order is the value order (-0 is first made
// +0).  Every NaN takes the largest key, an infeasible block the key of
// -inf: the lowest lane holding the largest key is torch.argmax's choice
// over the masked scores.  Branch-free, so that it stays beside the chain.
constexpr unsigned long long kKeyNaN = ~0ull;
constexpr unsigned long long kKeyNegInf = 0x000fffffffffffffull;
// A step's choice reduces the top 27 bits of each key's high word with the
// lane in the low 5: kTopNegInf is what -inf (and an infeasible block) gives
constexpr unsigned kTopNegInf = static_cast<unsigned>(kKeyNegInf >> 32) >> 5;

__device__ __forceinline__ unsigned long long order_key(double x) {
  const unsigned long long u =
      static_cast<unsigned long long>(__double_as_longlong(__dadd_rn(x, 0.0)));
  return u ^ (static_cast<unsigned long long>(static_cast<long long>(u) >> 63) | (1ull << 63));
}

__device__ __forceinline__ unsigned long long score_key(bool ok, double s) {
  const unsigned long long nan = 0ull - static_cast<unsigned long long>(isnan(s));
  const unsigned long long okm = 0ull - static_cast<unsigned long long>(ok);
  return ((order_key(s) | nan) & okm) | (kKeyNegInf & ~okm);
}

// The lowest lane holding the largest key: a redux of the high words, then
// one of the low words among the lanes that hold the high maximum.
__device__ __forceinline__ int lanes_first_max(unsigned long long key) {
  const unsigned hi = static_cast<unsigned>(key >> 32), lo = static_cast<unsigned>(key);
  const unsigned mh = __reduce_max_sync(kFull, hi);
  const unsigned ml = __reduce_max_sync(kFull, hi == mh ? lo : 0u);
  return __ffs(__ballot_sync(kFull, hi == mh && lo == ml)) - 1;
}

// A step's sums in segment order, one (label, prev, weight) entry at a time
// to every lane: `base` over the entries labelled with the lane's block,
// `alt` also over those to `vprev`, the node of the step before, as if its
// label were the lane's.  Long, direct or fractional segments take it.
template <bool kLabelsShared>
__device__ void ordered_sums(const SweepArgs& p, const SweepShared& r, const int32_t* lab_s,
                             int len, unsigned pos, long long a, long long vprev, double& base,
                             double& alt) {
  const int lane = threadIdx.x & 31;
  const bool staged = len <= kDirect;
  base = 0.0;
  alt = 0.0;
  for (int c = 0; c < len; c += 32) {
    const int e = c + lane;
    int lab = -1, prev = 0;
    double w = 0.0;
    if (e < len) {
      int ref;
      if (staged) {
        const unsigned slot = (pos + e) & (kRing - 1);
        ref = r.ring_ref[slot];
        prev = r.ring_prev[slot];
        w = r.ring_w[slot];
      } else {
        const long long d = p.edst[a + e];
        ref = entry_ref(p, d, vprev);
        prev = d == vprev;
        w = p.ew[a + e];
      }
      lab = label_at<kLabelsShared>(p, lab_s, ref);
    }
    unsigned hits = __ballot_sync(kFull, prev || (lab >= 0 && lab < 32));
    while (hits) {  // ascending entries: the segment's order
      const int t = __ffs(hits) - 1;
      hits &= hits - 1;
      const int lt = __shfl_sync(kFull, lab, t);
      const int pt = __shfl_sync(kFull, prev, t);
      const double wt = __shfl_sync(kFull, w, t);
      if (lt == lane) base = __dadd_rn(base, wt);
      if (lt == lane || pt) alt = __dadd_rn(alt, wt);
    }
  }
}

// A step's first kSlots staged entries, read ahead into registers.
struct SweepAhead {
  SweepMeta m;
  double2 mw;
  int4 ref[kSlots / 4];
  double2 w[kSlots / 2];
};

// Its metadata, then (once that has landed) its entries.
__device__ __forceinline__ void read_meta(const SweepShared& r, int step, SweepAhead& x) {
  const int slot = step & (kMeta - 1);
  x.m = r.meta[slot];
  x.mw = r.metaw[slot];
}

__device__ __forceinline__ void read_entries(const SweepShared& r, SweepAhead& x) {
  const unsigned at = x.m.pos & (kRing - 1);
  const int4* rr = reinterpret_cast<const int4*>(r.ring_ref + at);
  const double2* rw = reinterpret_cast<const double2*>(r.ring_w + at);
#pragma unroll
  for (int j = 0; j < kSlots / 4; ++j) x.ref[j] = rr[j];
#pragma unroll
  for (int j = 0; j < kSlots / 2; ++j) x.w[j] = rw[j];
}

// The labels of a step's first kSlots entries, as its refs say.
template <bool kLabelsShared>
__device__ __forceinline__ void read_labels(const SweepArgs& p, const int32_t* lab_s,
                                            const SweepAhead& x, int (&lab)[kSlots]) {
#pragma unroll
  for (int j = 0; j < kSlots / 4; ++j) {
    lab[4 * j] = label_at<kLabelsShared>(p, lab_s, x.ref[j].x);
    lab[4 * j + 1] = label_at<kLabelsShared>(p, lab_s, x.ref[j].y);
    lab[4 * j + 2] = label_at<kLabelsShared>(p, lab_s, x.ref[j].z);
    lab[4 * j + 3] = label_at<kLabelsShared>(p, lab_s, x.ref[j].w);
  }
}

// Lane b's sum of the weights labelled b, for a step whose sums are exact
// in any order: two chains of adds, then their sum.
__device__ __forceinline__ double lane_sum(const SweepAhead& x, const int (&lab)[kSlots]) {
  const int lane = threadIdx.x & 31;
  double even = 0.0, odd = 0.0;
#pragma unroll
  for (int j = 0; j < kSlots / 2; ++j) {
    if (lab[2 * j] == lane) even = __dadd_rn(even, x.w[j].x);
    if (lab[2 * j + 1] == lane) odd = __dadd_rn(odd, x.w[j].y);
  }
  return __dadd_rn(even, odd);
}

// The high word of score_key(ok, s): all a step's choice reduces.
__device__ __forceinline__ unsigned score_key_hi(bool ok, double s) {
  const unsigned h = static_cast<unsigned>(__double2hiint(__dadd_rn(s, 0.0)));
  const unsigned key = h ^ (static_cast<unsigned>(static_cast<int>(h) >> 31) | 0x80000000u);
  const unsigned nan = 0u - static_cast<unsigned>(isnan(s));
  const unsigned okm = 0u - static_cast<unsigned>(ok);
  return ((key | nan) & okm) | (static_cast<unsigned>(kKeyNegInf >> 32) & ~okm);
}

// Warp 0 for k <= 32: n_free dependent decisions, lane b holding block b
// (the design is in the comment at the top of this file).  Each
// warp-synchronous call, and the special-case branch of the square root,
// ends a block the compiler does not schedule across, so the source orders
// the work: the reduxes first, then the loads and sums the square root
// overlaps, the rare branch last.  The loop runs two steps an iteration,
// so that the read-ahead registers alternate instead of being copied.
// kStamp counts cycles and steps by branch into `stamps` (STAMP_KEYS).
template <bool kLabelsShared, bool kSqrt, bool kStamp>
__device__ void sweep_decide_lanes(const SweepArgs p, const SweepShared r, SweepSync& sync,
                                   int32_t* lab_s, long long* stamps) {
  const int lane = threadIdx.x & 31;
  const int n = p.n_free;
  long long st[kStamps] = {};
  long long t_a = kStamp ? clock64() : 0;
  const long long t_start = t_a;
  auto stamp = [&](int j) {
    if (kStamp) {
      const long long t_b = clock64();
      st[j] += t_b - t_a;
      t_a = t_b;
    }
  };
  auto count = [&](const SweepMeta& m) {  // a prepared step's summation path
    if (kStamp) {
      if (m.len > kDirect) {
        ++st[10];
      } else if (m.len > kSlots) {
        ++st[9];
      } else if (!(m.flags & kFast)) {
        ++st[11];
      } else if (m.flags & kHasPrev) {
        ++st[12];
      }
    }
  };

  // X: the block's load and penalty before the step; Y: after it, were the
  // block to take the step before (a lane past k never qualifies)
  double ld = lane < p.k ? p.loads[lane] : INFINITY;
  double pen = sweep_penalty<kSqrt>(ld, p.ag, p.g1);
  double ldy = ld, peny = pen;
  int avail = wait_staged(sync, n > 2 ? 2 : n - 1);
  SweepAhead xa, xb;  // step i+1's and step i+2's, alternating
  int la[kSlots], lb[kSlots];  // their labels
  read_meta(r, 0, xa);
  read_entries(r, xa);
  read_meta(r, 1, xb);
  read_entries(r, xb);
  read_labels<kLabelsShared>(p, lab_s, xa, la);
  read_labels<kLabelsShared>(p, lab_s, xb, lb);
  double base = lane_sum(xa, la), alt = base;
  if (!(xa.m.flags & kFast))
    ordered_sums<kLabelsShared>(p, r, lab_s, xa.m.len, xa.m.pos, r.meta_a[0], -1, base, alt);
  count(xa.m);
  // step i's scores and feasibility, for "my block did not take step i-1"
  // (c) and "it did" (a), and the high words of their keys
  bool okc = __dadd_rn(ld, xa.mw.x) <= p.cap, oka = okc;
  double sc = __dsub_rn(base, pen), sa = sc;
  unsigned hc = score_key_hi(okc, sc), ha = hc;
  int v_c = xa.m.v;
  double nw_c = xa.mw.x;
  int best_prev = -1;
  stamp(4);

  // step i, with step i+1's data and labels in xn and ln; reads step i+2's
  // data into xf and, once step i's label is stored, its labels into lf
  auto step = [&](int i, const SweepAhead& xn, const int (&ln)[kSlots], SweepAhead& xf,
                  int (&lf)[kSlots]) {
    // step i's choice: two reduxes of the keys' top 27 bits with the lane
    // below them find the largest and the lowest and highest lanes that
    // hold it; one lane above -inf settles the step
    const bool is_prev = lane == best_prev;
    const unsigned top = (is_prev ? ha : hc) & ~31u;
    const unsigned low = __reduce_max_sync(kFull, top | (31u - lane));
    const unsigned high = __reduce_max_sync(kFull, top | lane);
    int best = 31 - static_cast<int>(low & 31u);
    const bool settled = (low & 31u) + (high & 31u) == 31u && (low >> 5) > kTopNegInf;
    // beside it: the state before step i, step i+2's metadata and entries,
    // step i+1's sums, feasibility and scores, and Y for step i
    read_meta(r, i + 2, xf);  // stale past n, and then unused
    const bool ok_i = is_prev ? oka : okc;
    const double s_i = is_prev ? sa : sc;
    if (is_prev) {
      ld = ldy;
      pen = peny;
    }
    read_entries(r, xf);
    double base_n = lane_sum(xn, ln);
    const bool okc_n = __dadd_rn(ld, xn.mw.x) <= p.cap;
    ldy = __dadd_rn(ld, nw_c);
    const bool oka_n = __dadd_rn(ldy, xn.mw.x) <= p.cap;
    double alt_n = __dadd_rn(base_n, xn.mw.y);
    double sc_n = __dsub_rn(base_n, pen);
    peny = sweep_penalty<kSqrt>(ldy, p.ag, p.g1);
    double sa_n = __dsub_rn(alt_n, peny);
    unsigned hc_n = score_key_hi(okc_n, sc_n), ha_n = score_key_hi(oka_n, sa_n);
    stamp(0);

    // everything rare, in one branch: a step the reduxes do not settle (a
    // tie in the top bits, or no score above -inf), step i+1's ordered sums
    // (a long or inexact segment), and releases and waits; steps up to i+1
    // are done with, and step i+3 is read at the next step (release first,
    // or the stager may wait on us)
    const bool ordered = i + 1 < n && !(xn.m.flags & kFast);
    const bool wait = i + 3 < n && i + 3 >= avail;
    const bool give = wait || (i + 2 < n && (i & (kReleaseEvery - 1)) == kReleaseEvery - 1);
    if (!settled || ordered || give) {
      if (!settled) {
        if (__any_sync(kFull, ok_i)) {
          best = lanes_first_max(score_key(ok_i, s_i));
          if (kStamp) ++st[7];
        } else {  // no feasible block: the first least-loaded one
          best = lanes_first_max(isnan(ld) ? kKeyNaN : ~order_key(ld));
          if (kStamp) ++st[8];
        }
        stamp(1);
      }
      if (ordered) {
        ordered_sums<kLabelsShared>(p, r, lab_s, xn.m.len, xn.m.pos,
                                    r.meta_a[(i + 1) & (kMeta - 1)], v_c, base_n, alt_n);
        sc_n = __dsub_rn(base_n, pen);
        sa_n = __dsub_rn(alt_n, peny);
        hc_n = score_key_hi(okc_n, sc_n);
        ha_n = score_key_hi(oka_n, sa_n);
        stamp(2);
      }
      if (give) release(sync, i + 2, xf.m.pos);
      if (wait) {
        const long long t_w = kStamp ? clock64() : 0;
        avail = wait_staged(sync, i + 3);
        if (kStamp) {
          st[15] += clock64() - t_w;
          ++st[16];
        }
      }
    }
    if (i + 1 < n) count(xn.m);
    set_label<kLabelsShared>(p, lab_s, v_c, best);
    read_labels<kLabelsShared>(p, lab_s, xf, lf);
    stamp(3);
    best_prev = best;
    v_c = xn.m.v;
    nw_c = xn.mw.x;
    sc = sc_n;
    sa = sa_n;
    hc = hc_n;
    ha = ha_n;
    okc = okc_n;
    oka = oka_n;
  };
  int i = 0;
  for (; i + 1 < n; i += 2) {
    step(i, xb, lb, xa, la);
    step(i + 1, xa, la, xb, lb);
  }
  if (i < n) step(i, xb, lb, xa, la);
  if (lane == best_prev) ld = ldy;
  if (lane < p.k) p.loads[lane] = ld;

  if (kStamp) {
    st[5] = clock64() - t_start;
    st[6] = n;
    // the chain alone, iterated on the last keys: the floor of a step
    int b = best_prev;
    const long long t0 = clock64();
    for (int j = 0; j < kChainReps; ++j) {
      const unsigned t = (lane == b ? ha : hc) & ~31u;
      const unsigned lo_lane = __reduce_max_sync(kFull, t | (31u - lane));
      const unsigned hi_lane = __reduce_max_sync(kFull, t | lane);
      b = static_cast<int>((31u - (lo_lane & 31u) + (hi_lane & 31u)) & 31u);
    }
    st[13] = clock64() - t0 + (b >> 31);
    st[14] = kChainReps;
    if (lane == 0)
      for (int j = 0; j < 17; ++j) stamps[j] = st[j];
  }
}

// Warp 0 for k > 32: `karr` holds the loads, penalties and sums, lane
// b % 32 owning block b; each step reads its labels after the step before
// is decided and sums its hits one at a time.
template <bool kLabelsShared>
__device__ void sweep_decide_blocks(const SweepArgs p, const SweepShared r, SweepSync& sync,
                                    int32_t* lab_s, double* karr) {
  const int lane = threadIdx.x & 31;
  const int k = p.k;
  double* kload = karr;
  double* kpen = karr + k;
  double* kconn = karr + 2 * k;
  int avail = 0, best_prev = -1;
  for (int i = 0; i < p.n_free; ++i) {
    if (i >= avail) avail = wait_staged(sync, i);
    const int slot = i & (kMeta - 1);
    const SweepMeta m = r.meta[slot];
    const double nw = r.metaw[slot].x;
    const bool staged = m.len <= kDirect;
    const long long a = staged ? 0 : r.meta_a[slot];

    // connection sums, in segment order; an entry to the node of the step
    // before was staged without its label, which is best_prev
    for (int c = 0; c < m.len; c += 32) {
      const int e = c + lane;
      int lab = -1;
      double w = 0.0;
      if (e < m.len) {
        if (staged) {
          const unsigned at = (m.pos + e) & (kRing - 1);
          lab = r.ring_prev[at] ? best_prev : label_at<kLabelsShared>(p, lab_s, r.ring_ref[at]);
          w = r.ring_w[at];
        } else {
          lab = label_at<kLabelsShared>(p, lab_s, entry_ref(p, p.edst[a + e], LLONG_MIN));
          w = p.ew[a + e];
        }
      }
      unsigned hits = __ballot_sync(kFull, lab >= 0 && lab < k);
      while (hits) {  // ascending entries: the segment's order
        const int t = __ffs(hits) - 1;
        hits &= hits - 1;
        const int lt = __shfl_sync(kFull, lab, t);
        const double wt = __shfl_sync(kFull, w, t);
        if ((lt & 31) == lane) kconn[lt] = __dadd_rn(kconn[lt], wt);
      }
    }

    // the decision
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
    int best;
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
    set_label<kLabelsShared>(p, lab_s, m.v, best);
    release(sync, i + 1, m.pos + static_cast<unsigned>(footprint(m.len)));
    best_prev = best;
  }
}

template <bool kLabelsShared, bool kLanesK, bool kSqrt, bool kStamp>
__global__ void __launch_bounds__(kSweepThreads, 1)
fennel_sweep_kernel(SweepArgs p, long long* stamps) {
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  __shared__ SweepSync sync;
  SweepShared r;
  r.metaw = reinterpret_cast<double2*>(sweep_smem);
  r.ring_w = reinterpret_cast<double*>(r.metaw + kMeta);
  r.ring_ref = reinterpret_cast<int*>(r.ring_w + kRing);
  r.meta = reinterpret_cast<SweepMeta*>(r.ring_ref + kRing);
  r.meta_a = reinterpret_cast<long long*>(r.meta + kMeta);
  r.ring_prev = reinterpret_cast<unsigned char*>(r.meta_a + kMeta);
  unsigned char* tail = sweep_smem + kSweepBaseBytes;
  double* karr = p.k_shared ? reinterpret_cast<double*>(tail) : p.scratch;
  int32_t* lab_s = reinterpret_cast<int32_t*>(tail + (p.k_shared ? 24LL * p.k : 0));

  if (threadIdx.x == 0) {
    sync.produced = 0;
    sync.consumed = 0;
    sync.consumed_pos = 0;
  }
  // every entry a read ahead may reach holds a valid label offset
  for (int i = threadIdx.x; i < kRing; i += kSweepThreads) {
    r.ring_ref[i] = p.ref_none;
    r.ring_w[i] = 0.0;
  }
  for (int i = threadIdx.x; i < kMeta; i += kSweepThreads) {
    r.meta[i] = SweepMeta{0, 0u, 0, 0};
    r.metaw[i] = make_double2(0.0, 0.0);
  }
  if (kLabelsShared) {
#pragma unroll 8
    for (long long i = threadIdx.x; i < p.n_pad; i += kSweepThreads)
      lab_s[i] = static_cast<int32_t>(p.labels[i]);
    if (threadIdx.x == 0) lab_s[p.n_pad] = -1;
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
    if constexpr (kLanesK) {
      sweep_decide_lanes<kLabelsShared, kSqrt, kStamp>(p, r, sync, lab_s, stamps);
    } else {
      sweep_decide_blocks<kLabelsShared>(p, r, sync, lab_s, karr);
    }
  } else if (warp == 1) {
    sweep_stage<kStamp>(p, r, sync, stamps);
  }
  __syncthreads();
  if (kLabelsShared) {
    for (long long i = threadIdx.x; i < p.n_pad; i += kSweepThreads) p.labels[i] = lab_s[i];
  }
  if (!kLanesK) {
    for (int b = threadIdx.x; b < p.k; b += kSweepThreads) p.loads[b] = karr[b];
  }
}

template <bool kLabelsShared, bool kLanesK, bool kSqrt, bool kStamp>
int launch_sweep(const SweepArgs& p, long long bytes, long long* stamps, cudaStream_t stream) {
  static long long granted[kMaxDevices] = {};
  int device = 0;
  const int err =
      reserve_shared(fennel_sweep_kernel<kLabelsShared, kLanesK, kSqrt, kStamp>, bytes,
                     static_cast<long long>(sizeof(SweepSync)), granted, &device);
  if (err != 0) return err;
  fennel_sweep_kernel<kLabelsShared, kLanesK, kSqrt, kStamp>
      <<<1, kSweepThreads, static_cast<size_t>(bytes), stream>>>(p, stamps);
  return static_cast<int>(cudaGetLastError());
}

// The sweep's arguments and dynamic shared memory, and its route: labels
// in shared memory where n_pad + 1 of them fit beside the ring, lanes as
// blocks for k <= 32.  Returns 0, kErrShape or kErrSharedMemory.
int plan_sweep(const void* edst, const void* ew, const void* node_w, const void* order,
               const void* indptr, void* labels, void* loads, void* scratch, long long n_pad,
               long long n_free, int k, double ag, double g1, double cap, SweepArgs* p,
               long long* bytes, bool* labels_shared) {
  if (n_free > INT_MAX || k <= 0 || n_pad >= (1LL << 29)) return kErrShape;
  int limit = 0;
  const int err = optin_bytes(&limit);
  if (err != 0) return err;
  const long long room = limit - static_cast<long long>(sizeof(SweepSync)) - kSweepBaseBytes;
  if (room < 0) return kErrSharedMemory;
  const long long label_bytes = 4 * (n_pad + 1);
  *labels_shared = label_bytes <= room;
  const long long left = room - (*labels_shared ? label_bytes : 0);
  const bool k_shared = k > 32 && 24LL * k <= left;
  *bytes = kSweepBaseBytes + (*labels_shared ? label_bytes : 0) + (k_shared ? 24LL * k : 0);
  *p = SweepArgs{static_cast<const long long*>(edst), static_cast<const double*>(ew),
                 static_cast<const double*>(node_w), static_cast<const long long*>(order),
                 static_cast<const long long*>(indptr), static_cast<long long*>(labels),
                 static_cast<double*>(loads), static_cast<double*>(scratch), n_pad,
                 static_cast<int>(4 * n_pad), static_cast<int>(n_free), k, ag, g1, cap,
                 k_shared ? 1 : 0};
  return 0;
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
  SweepArgs p;
  long long bytes = 0;
  bool shared = false;
  const int err = plan_sweep(edst, ew, node_w, order, indptr, labels, loads, scratch, n_pad,
                             n_free, k, ag, g1, cap, &p, &bytes, &shared);
  if (err != 0) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (k > 32) {
    return shared ? launch_sweep<true, false, false, false>(p, bytes, nullptr, s)
                  : launch_sweep<false, false, false, false>(p, bytes, nullptr, s);
  }
  if (g1 == 0.5) {
    return shared ? launch_sweep<true, true, true, false>(p, bytes, nullptr, s)
                  : launch_sweep<false, true, true, false>(p, bytes, nullptr, s);
  }
  return shared ? launch_sweep<true, true, false, false>(p, bytes, nullptr, s)
                : launch_sweep<false, true, false, false>(p, bytes, nullptr, s);
}

// The same sweep with clock64() stamps (`stamps`: 19 int64, see
// sweep_decide_lanes), on the main path's route only: k <= 32, labels in
// shared memory, gamma = 1.5; kErrShape otherwise.  For measurement: the
// stamps change the schedule, and fennel_sweep never calls it.
extern "C" int fennel_sweep_stamped_launch(const void* edst, const void* ew,
                                           const void* node_w, const void* order,
                                           const void* indptr, void* labels, void* loads,
                                           void* scratch, long long n_pad, long long n_free,
                                           int k, double ag, double g1, double cap,
                                           void* stream, void* stamps) {
  if (n_free <= 0) return static_cast<int>(cudaSuccess);
  SweepArgs p;
  long long bytes = 0;
  bool shared = false;
  const int err = plan_sweep(edst, ew, node_w, order, indptr, labels, loads, scratch, n_pad,
                             n_free, k, ag, g1, cap, &p, &bytes, &shared);
  if (err != 0) return err;
  if (k > 32 || !shared || g1 != 0.5) return kErrShape;
  return launch_sweep<true, true, true, true>(p, bytes, static_cast<long long*>(stamps),
                                              static_cast<cudaStream_t>(stream));
}
