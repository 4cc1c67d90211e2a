// seg_scan_or: segmented OR-carry scan over int32 words.
//
// Replaces the Pallas TPU kernel
//   src/debwt_tpu/kernels/seg_or.py::seg_scan_or (and seg_suffix_or)
//
//   suffix:  out[i] = w[i] | (w[i] & STOP ? 0 : out[i + 1])
//   prefix:  out[i] = w[i] | (w[i] & STOP ? 0 : out[i - 1])
//
// The Pallas kernel carries its scan from tile to tile through SMEM and
// relies on the TPU walking its grid in order. CUDA blocks run in no
// order, so this kernel uses reduce-then-scan in three launches:
//
//   1. seg_or_reduce: each block scans one tile of kTile words and
//      writes the tile's aggregate;
//   2. seg_or_carry:  one block scans the tile aggregates and writes
//      each tile's carry-in (exclusive prefix);
//   3. seg_or_apply:  each block rescans its tile and folds its carry in.
//
// Both directions share the code: logical position k maps to physical
// index k (prefix) or R - 1 - k (suffix), and a logical inclusive scan
// runs under the associative operator
//
//   op(earlier, later) = later | (later & STOP ? 0 : earlier)
//
// with identity 0 (the ragged last tile pads with 0). Whole words are
// scanned, so out[i] also carries STOP iff a stop lies between i and the
// scan's far end; callers mask with STOP - 1.
//
// What bounds it on an H100: bytes. The function reads R words and
// writes R words (at R = 167,772,288: 1.34 GB, ~0.40 ms at 3.35 TB/s);
// this form reads the words twice (steps 1 and 3), so it moves 1.5x the
// bound. Within a block the scan runs on warp shuffles and one
// shared-memory pass over the 32 warp totals. A single-pass decoupled
// look-back scan would drop the second read and is left for later.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;         // words per block, one per thread
constexpr int kWarps = kTile / 32;  // == 32: warp 0 scans the totals
constexpr int kCarryThreads = 1024;

__device__ __forceinline__ int op(int earlier, int later, int stop) {
  return later | ((later & stop) ? 0 : earlier);
}

// Inclusive scan of one value per thread across a block of exactly
// kTile threads (32 warps). `warp_tot` is shared scratch of kWarps ints.
__device__ __forceinline__ int block_scan(int x, int stop, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = op(y, x, stop);
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = warp_tot[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t = op(y, t, stop);
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) x = op(warp_tot[warp - 1], x, stop);
  return x;
}

__device__ __forceinline__ long long phys(long long k, long long n,
                                          int prefix) {
  return prefix ? k : n - 1 - k;
}

__global__ void __launch_bounds__(kTile)
seg_or_reduce(const int* __restrict__ w, long long n, int stop, int prefix,
              int* __restrict__ agg) {
  __shared__ int warp_tot[kWarps];
  const long long k = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  const int x = k < n ? w[phys(k, n, prefix)] : 0;
  const int incl = block_scan(x, stop, warp_tot);
  if (threadIdx.x == kTile - 1) agg[blockIdx.x] = incl;
}

__global__ void __launch_bounds__(kCarryThreads)
seg_or_carry(const int* __restrict__ agg, int* __restrict__ carry,
             long long n_tiles, int stop) {
  __shared__ int warp_tot[kWarps];
  __shared__ int incl_of[kCarryThreads];
  // each thread owns a contiguous run of tiles
  const long long per = (n_tiles + kCarryThreads - 1) / kCarryThreads;
  const long long lo = threadIdx.x * per;
  const long long hi = lo + per < n_tiles ? lo + per : n_tiles;
  int acc = 0;
  for (long long t = lo; t < hi; ++t) acc = op(acc, agg[t], stop);
  incl_of[threadIdx.x] = block_scan(acc, stop, warp_tot);
  __syncthreads();
  int run = threadIdx.x == 0 ? 0 : incl_of[threadIdx.x - 1];
  for (long long t = lo; t < hi; ++t) {
    carry[t] = run;
    run = op(run, agg[t], stop);
  }
}

__global__ void __launch_bounds__(kTile)
seg_or_apply(const int* __restrict__ w, int* __restrict__ out, long long n,
             int stop, int prefix, const int* __restrict__ carry) {
  __shared__ int warp_tot[kWarps];
  const long long k = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  const long long p = phys(k, n, prefix);
  const int x = k < n ? w[p] : 0;
  const int incl = op(carry[blockIdx.x], block_scan(x, stop, warp_tot), stop);
  if (k < n) out[p] = incl;
}

}  // namespace

extern "C" int debwt_seg_or_tile() { return kTile; }

// words, out: int32[n]; agg, carry: int32[ceil(n / kTile)] scratch.
extern "C" int debwt_seg_scan_or(const void* words, void* out, long long n,
                                 int stop, int prefix, void* agg, void* carry,
                                 void* stream) {
  if (n <= 0 || stop <= 0 || (stop & (stop - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_tiles = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* w = static_cast<const int*>(words);
  int* a = static_cast<int*>(agg);
  int* c = static_cast<int*>(carry);
  seg_or_reduce<<<static_cast<unsigned>(n_tiles), kTile, 0, s>>>(
      w, n, stop, prefix, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_or_carry<<<1, kCarryThreads, 0, s>>>(a, c, n_tiles, stop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_or_apply<<<static_cast<unsigned>(n_tiles), kTile, 0, s>>>(
      w, static_cast<int*>(out), n, stop, prefix, c);
  return static_cast<int>(cudaGetLastError());
}
