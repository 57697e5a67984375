// The V-cycle's level-0 buffers written on the card from a compact CSR, for
// sm_90a.
//
// In: the batch model's CSR as the host holds it — indptr (n+1, int64),
// indices (e, int32), edge_w (e, float32), node_w (n, float32), pinned (n,
// int64).  Out, in one launch, what `CSRGraph.to_coo_padded` and
// `to_ell_padded` write on the host, widened as the V-cycle reads them:
//
//   esrc, edst (e_pad, int64), ew (e_pad, float64): edge j < e is (row of j,
//       indices[j], edge_w[j]); the tail [e, e_pad) is (n_pad, n_pad, 0);
//   node_w (n_pad, float64), pin (n_pad, int64): padded with 0 and -2;
//   nbr (n_pad, w_pad, int64), wts (n_pad, w_pad, float32), when w_pad > 0:
//       row r < n holds its first min(deg r, w_pad) neighbours and weights in
//       CSR order, the rest -1 and 0; rows [n, n_pad) are all -1 and 0.
//
// Replaces no TPU kernel: the reference packs these buffers on the host
// (repro/core/multilevel_jax.py) and uploads them padded.  This kernel lets
// the host upload the compact CSR (~8 bytes an edge) in place of the padded
// buffers (24 bytes a padded edge, 12 an ELL slot).
//
// Bound: memory, by its writes: 24*e_pad + 16*n_pad + 12*n_pad*w_pad bytes
// (its reads, ~8*e + 20*n, are a fraction of that).  So neighbouring threads
// write neighbouring elements with 16-byte stores: an edge thread owns two
// slots, a tile thread four slots of one row (w_pad is a multiple of four).
// The grid is split into three ranges of blocks — edge slots, node slots,
// tile slots — so no block diverges between them.  An edge thread finds its
// first slot's row by a binary search over indptr: a warp's consecutive
// slots walk the same path but for the last steps, so the search reads a
// few cached lines a warp and no device-memory bandwidth, but its ~16
// dependent loads are the kernel's latency; its second slot's row follows
// from the first, galloping past empty rows.  A thread that owned more
// slots would walk them one after another and take longer (4 slots a thread
// measured 1.02-1.73x the time of 2 at the pack shapes of the cells' own
// batches; PERF.md), and a row-per-warp walk would leave a hub row of tens
// of thousands of edges to one warp.  A tile thread reads its row's two
// indptr entries (one line a warp) and its neighbours.  Every value is a
// copy or an exact widening, so the result is the host's bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kEdgeItems = 2;  // edge slots a thread: one 16-byte store an array
constexpr int kTileItems = 4;  // tile slots a thread (w_pad is a multiple of it)
constexpr int kErrShape = -2;

struct Args {
  const int64_t* indptr;
  const int32_t* indices;
  const float* edge_w;
  const float* node_w_in;
  const int64_t* pin_in;
  int64_t* esrc;
  int64_t* edst;
  double* ew;
  double* node_w;
  int64_t* pin;
  int64_t* nbr;
  float* wts;
  long long n, e, n_pad, e_pad, w_pad;
  int w_shift;                   // log2(w_pad) when it is a power of two, else -1
  long long edge_blocks, node_blocks;
};

// The row r in [0, n) with indptr[r] <= j < indptr[r + 1] (j < e, so n >= 1):
// the last r with indptr[r] <= j, which skips empty rows.
__device__ __forceinline__ long long row_of(const int64_t* __restrict__ indptr, long long n,
                                            long long j) {
  long long lo = 0, hi = n;  // indptr[lo] <= j < indptr[hi]
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(indptr + mid) <= j) lo = mid; else hi = mid;
  }
  return lo;
}

// The row of j (< e) when the row `row` ends at or before j: gallop from
// row + 1 past the empty rows (a run of them is common where a batch keeps
// few internal edges), then bisect; two loads when the next row holds j.
__device__ __forceinline__ long long row_after(const int64_t* __restrict__ indptr, long long n,
                                               long long row, long long j) {
  long long lo = row + 1, step = 1, hi = lo + 1;  // indptr[lo] <= j
  while (hi < n && __ldg(indptr + hi) <= j) {
    lo = hi;
    step <<= 1;
    hi = lo + step;
  }
  if (hi > n) hi = n;  // indptr[lo] <= j < indptr[hi]
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(indptr + mid) <= j) lo = mid; else hi = mid;
  }
  return lo;
}

// Edge slots [j0, j0 + kEdgeItems): the first slot's row found by search,
// the next ones' from it, stored as 16-byte vectors where the run is whole
// (j0 is a multiple of kEdgeItems, and torch's allocations are 16-byte
// aligned).
__device__ __forceinline__ void pack_edges(const Args& a, long long j0) {
  int64_t src[kEdgeItems], dst[kEdgeItems];
  double w[kEdgeItems];
  long long row = j0 < a.e ? row_of(a.indptr, a.n, j0) : 0;
#pragma unroll
  for (int i = 0; i < kEdgeItems; ++i) {
    const long long j = j0 + i;
    if (j < a.e) {
      if (__ldg(a.indptr + row + 1) <= j) row = row_after(a.indptr, a.n, row, j);
      src[i] = row;
      dst[i] = __ldg(a.indices + j);
      w[i] = __ldg(a.edge_w + j);
    } else {
      src[i] = a.n_pad;
      dst[i] = a.n_pad;
      w[i] = 0.0;
    }
  }
  if (j0 + kEdgeItems <= a.e_pad) {
#pragma unroll
    for (int i = 0; i < kEdgeItems; i += 2) {
      *reinterpret_cast<longlong2*>(a.esrc + j0 + i) = make_longlong2(src[i], src[i + 1]);
      *reinterpret_cast<longlong2*>(a.edst + j0 + i) = make_longlong2(dst[i], dst[i + 1]);
      *reinterpret_cast<double2*>(a.ew + j0 + i) = make_double2(w[i], w[i + 1]);
    }
  } else {
    for (int i = 0; i < kEdgeItems && j0 + i < a.e_pad; ++i) {
      a.esrc[j0 + i] = src[i];
      a.edst[j0 + i] = dst[i];
      a.ew[j0 + i] = w[i];
    }
  }
}

// Tile slots [t0, t0 + kTileItems) of one row: the row's bounds read once,
// the run stored as 16-byte vectors.
__device__ __forceinline__ void pack_tile_run(const Args& a, long long t0) {
  const long long r = a.w_shift >= 0 ? t0 >> a.w_shift : t0 / a.w_pad;
  const long long c0 = t0 - r * a.w_pad;
  int64_t v[kTileItems];
  float x[kTileItems];
  long long start = 0, deg = 0;
  if (r < a.n) {
    start = __ldg(a.indptr + r);
    deg = __ldg(a.indptr + r + 1) - start;  // slots past it, and past w_pad, stay empty
  }
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) {
    const bool take = c0 + i < deg;
    v[i] = take ? __ldg(a.indices + start + c0 + i) : -1;
    x[i] = take ? __ldg(a.edge_w + start + c0 + i) : 0.0f;
  }
  *reinterpret_cast<longlong2*>(a.nbr + t0) = make_longlong2(v[0], v[1]);
  *reinterpret_cast<longlong2*>(a.nbr + t0 + 2) = make_longlong2(v[2], v[3]);
  *reinterpret_cast<float4*>(a.wts + t0) = make_float4(x[0], x[1], x[2], x[3]);
}

__global__ void __launch_bounds__(kThreads) csr_pack_kernel(const Args a) {
  const long long block = blockIdx.x;
  if (block < a.edge_blocks) {
    const long long j0 = (block * kThreads + threadIdx.x) * kEdgeItems;
    if (j0 < a.e_pad) pack_edges(a, j0);
    return;
  }
  if (block < a.edge_blocks + a.node_blocks) {
    const long long i = (block - a.edge_blocks) * kThreads + threadIdx.x;
    if (i >= a.n_pad) return;
    const bool real = i < a.n;
    a.node_w[i] = real ? static_cast<double>(__ldg(a.node_w_in + i)) : 0.0;
    a.pin[i] = real ? __ldg(a.pin_in + i) : -2;
    return;
  }
  const long long t0 = ((block - a.edge_blocks - a.node_blocks) * kThreads + threadIdx.x) *
                       kTileItems;
  if (t0 < a.n_pad * a.w_pad) pack_tile_run(a, t0);
}

long long blocks_for(long long items) { return (items + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so a refused launch is seen,
// or kErrShape.  `nbr` and `wts` are written only when w_pad > 0, a multiple
// of kTileItems.
extern "C" int csr_pack_launch(const void* indptr, const void* indices, const void* edge_w,
                               const void* node_w_in, const void* pin_in, void* esrc,
                               void* edst, void* ew, void* node_w, void* pin, void* nbr,
                               void* wts, long long n, long long e, long long n_pad,
                               long long e_pad, long long w_pad, void* stream) {
  if (n < 0 || e < 0 || w_pad < 0 || w_pad % kTileItems != 0 || n > n_pad || e > e_pad ||
      (e > 0 && n == 0))
    return kErrShape;
  Args a;
  a.indptr = static_cast<const int64_t*>(indptr);
  a.indices = static_cast<const int32_t*>(indices);
  a.edge_w = static_cast<const float*>(edge_w);
  a.node_w_in = static_cast<const float*>(node_w_in);
  a.pin_in = static_cast<const int64_t*>(pin_in);
  a.esrc = static_cast<int64_t*>(esrc);
  a.edst = static_cast<int64_t*>(edst);
  a.ew = static_cast<double*>(ew);
  a.node_w = static_cast<double*>(node_w);
  a.pin = static_cast<int64_t*>(pin);
  a.nbr = static_cast<int64_t*>(nbr);
  a.wts = static_cast<float*>(wts);
  a.n = n;
  a.e = e;
  a.n_pad = n_pad;
  a.e_pad = e_pad;
  a.w_pad = w_pad;
  a.w_shift = -1;
  for (int s = 0; s < 63; ++s) {
    if ((1LL << s) == w_pad) a.w_shift = s;
  }
  a.edge_blocks = blocks_for((e_pad + kEdgeItems - 1) / kEdgeItems);
  a.node_blocks = blocks_for(n_pad);
  const long long blocks =
      a.edge_blocks + a.node_blocks + blocks_for(n_pad * w_pad / kTileItems);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return kErrShape;
  csr_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
