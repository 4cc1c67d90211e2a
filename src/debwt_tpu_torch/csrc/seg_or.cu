// seg_scan_or: segmented OR-carry scan over int32 words.
//
// Replaces the Pallas TPU kernel
//   src/debwt_tpu/kernels/seg_or.py::seg_scan_or (and seg_suffix_or)
//
//   suffix:  out[i] = w[i] | (w[i] & STOP ? 0 : out[i + 1])
//   prefix:  out[i] = w[i] | (w[i] & STOP ? 0 : out[i - 1])
//
// A logical inclusive scan under the associative, NOT commutative
// operator
//
//   op(earlier, later) = later | (later & STOP ? 0 : earlier)
//
// with identity 0. Whole words are scanned, so out[i] also carries STOP
// iff a stop lies between i and the scan's far end; callers mask with
// STOP - 1. The suffix direction is the mirror image of the prefix
// direction at every level (tile, warp, chunk, lane, word).
//
// What bounds it on an H100: bytes. The function reads R words and
// writes R words (at R = 167,772,288: 1.34 GB, 0.40 ms at 3.35 TB/s);
// the arithmetic is a few operations a word. The Pallas kernel carries
// its scan from tile to tile through SMEM and relies on the TPU walking
// its grid in order; CUDA blocks run in no order. So the design is a
// single pass with decoupled look-back (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016; written
// here by hand, nothing of CUB is called): every word is read once and
// written once, in one launch.
//
//   * A block of kThreads threads owns one tile of kTile = kThreads * 16
//     words. Tiles are anchored PHYSICALLY at multiples of kTile in both
//     directions, so every 16-byte load and store is aligned whatever R
//     is; the ragged tile (padded with the identity) is the last logical
//     tile of the prefix direction and the first of the suffix direction.
//   * Each warp owns 512 consecutive words as four rows of 128; lane l
//     loads words 4l..4l+3 of each row with one 16-byte load, so a warp's
//     load covers 512 contiguous bytes. A thread scans each of its four
//     chunks serially in registers; the chunk totals go through one
//     shuffle ladder per row, the four row totals chain serially, and the
//     warp totals meet in shared memory. Two block barriers a tile beside
//     the ticket's, and 16 KB of loads in flight a block.
//   * A tile takes its logical index from an atomicAdd ticket, not from
//     blockIdx.x: a block may then spin on its predecessors, because each
//     of them already runs.
//   * Each tile publishes ONE 64-bit descriptor, status << 32 | value,
//     written with one store and read with one load, so flag and value
//     never tear and no fence is needed. Status: 0 empty, 1 aggregate of
//     the tile alone, 2 inclusive prefix up to the tile's end. An
//     aggregate that carries STOP absorbs all that came before it, so it
//     IS an inclusive prefix and is published as one at once. Warp 0
//     looks back over 32 descriptors at a time, nearest first, up to the
//     nearest inclusive one, and folds them in order.
//
// The descriptors (one a tile) and the ticket must be zero at launch;
// the caller provides them. Measured on an H100 80GB HBM3 at 700 W
// (PERF.md): 0.55 ms at R = 167,772,288 with a stop every 20 rows, 0.69 ms
// with no stop at all (every look-back rides on published prefixes),
// beside 0.45 ms for a plain copy of the same words.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                  // 16-byte chunks per thread
constexpr int kRowWords = 32 * 4;         // words in one row of a warp
constexpr int kWarpWords = kRows * kRowWords;
constexpr int kTile = kWarps * kWarpWords;  // 4096 words per block

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

__device__ __forceinline__ int op(int earlier, int later, int stop) {
  return later | ((later & stop) ? 0 : earlier);
}

// The value of the logically previous lane at distance d.
template <bool kPrefix>
__device__ __forceinline__ int shfl_earlier(int x, int d) {
  return kPrefix ? __shfl_up_sync(kFull, x, d) : __shfl_down_sync(kFull, x, d);
}

__device__ __forceinline__ unsigned long long load_desc(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_desc(unsigned long long* p,
                                           unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Warp 0 of tile `tile` (> 0): the fold of every tile before it. Lane l
// reads the descriptor of tile (top - l); a window is folded once every
// lane nearer than the nearest inclusive descriptor is published.
__device__ __forceinline__ int look_back(const unsigned long long* desc,
                                         long long tile, int stop, int lane) {
  int carry = 0;          // fold of the windows read so far (all later)
  long long top = tile - 1;
  while (true) {
    const long long t = top - lane;
    unsigned long long d;
    unsigned empty, incl;
    do {
      // tiles before tile 0 read as an inclusive identity
      d = t >= 0 ? load_desc(desc + t) : kInclusive;
      const unsigned status = static_cast<unsigned>(d >> 32);
      empty = __ballot_sync(kFull, status == 0);
      incl = __ballot_sync(kFull, status == 2);
      // spin while an empty descriptor is nearer than the nearest
      // inclusive one
    } while (empty & (incl ? ((incl & (0u - incl)) - 1u) : kFull));
    const int last = incl ? __ffs(incl) - 1 : 31;
    int v = lane <= last ? static_cast<int>(d & 0xffffffffull) : 0;
    // ordered fold: lane + d is the EARLIER tile
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_down_sync(kFull, v, s);
      if (lane + s < 32) v = op(y, v, stop);
    }
    v = __shfl_sync(kFull, v, 0);
    carry = op(v, carry, stop);
    if (incl) return carry;
    top -= 32;
  }
}

template <bool kPrefix>
__global__ void __launch_bounds__(kThreads)
seg_or_scan(const int* __restrict__ w, int* __restrict__ out, long long n,
            long long n_tiles, int stop, int vec_ok,
            unsigned long long* desc, unsigned int* ticket) {
  __shared__ long long s_tile;
  __shared__ int s_warp_tot[kWarps];
  __shared__ int s_carry;

  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;                       // logical index
  const long long ptile = kPrefix ? tile : n_tiles - 1 - tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lwarp = kPrefix ? warp : kWarps - 1 - warp;  // logical warp
  const long long base = ptile * kTile + warp * kWarpWords + lane * 4;

  // ---- load: physical row r -> logical row, words in logical order ----
  int x[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long g = base + r * kRowWords;
    int a, b, c, d;
    if (vec_ok && g + 4 <= n) {
      const int4 v = *reinterpret_cast<const int4*>(w + g);
      a = v.x; b = v.y; c = v.z; d = v.w;
    } else {
      a = g < n ? w[g] : 0;
      b = g + 1 < n ? w[g + 1] : 0;
      c = g + 2 < n ? w[g + 2] : 0;
      d = g + 3 < n ? w[g + 3] : 0;
    }
    const int j = kPrefix ? r : kRows - 1 - r;
    x[j][0] = kPrefix ? a : d;
    x[j][1] = kPrefix ? b : c;
    x[j][2] = kPrefix ? c : b;
    x[j][3] = kPrefix ? d : a;
  }

  // ---- thread: serial inclusive scan of each chunk ----
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int k = 1; k < 4; ++k) x[j][k] = op(x[j][k - 1], x[j][k], stop);
  }

  // ---- warp: one ladder per row over the chunk totals, rows chained ----
  const int llane = kPrefix ? lane : 31 - lane;        // logical lane
  int pre[kRows];     // fold of everything in the warp before chunk j
  int row_carry = 0;  // fold of the warp's rows before row j
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    int s = x[j][3];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = shfl_earlier<kPrefix>(s, d);
      if (llane >= d) s = op(y, s, stop);
    }
    int before = shfl_earlier<kPrefix>(s, 1);
    if (llane == 0) before = 0;
    pre[j] = op(row_carry, before, stop);
    const int row_tot = __shfl_sync(kFull, s, kPrefix ? 31 : 0);
    row_carry = op(row_carry, row_tot, stop);
  }
  if (lane == 0) s_warp_tot[lwarp] = row_carry;
  __syncthreads();

  // ---- block: fold the warp totals; warp 0 looks back ----
  int warp_carry = 0;  // fold of the logical warps before this one
  int agg = 0;         // fold of the whole tile
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    if (v == lwarp) warp_carry = agg;
    agg = op(agg, s_warp_tot[v], stop);
  }
  if (warp == 0) {
    // tile 0's aggregate, and one that carries STOP, are inclusive
    const bool closed = tile == 0 || (agg & stop);
    if (lane == 0) {
      store_desc(desc + tile, (closed ? kInclusive : kAggregate) |
                                  static_cast<unsigned int>(agg));
    }
    int carry = 0;
    if (tile > 0) carry = look_back(desc, tile, stop, lane);
    if (lane == 0) {
      if (!closed) {
        store_desc(desc + tile,
                   kInclusive | static_cast<unsigned int>(op(carry, agg, stop)));
      }
      s_carry = carry;
    }
  }
  __syncthreads();
  const int carry = op(s_carry, warp_carry, stop);

  // ---- store in physical order ----
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = kPrefix ? r : kRows - 1 - r;
    const int p = op(carry, pre[j], stop);
    const int y0 = op(p, x[j][0], stop);
    const int y1 = op(p, x[j][1], stop);
    const int y2 = op(p, x[j][2], stop);
    const int y3 = op(p, x[j][3], stop);
    const int a = kPrefix ? y0 : y3;
    const int b = kPrefix ? y1 : y2;
    const int c = kPrefix ? y2 : y1;
    const int d = kPrefix ? y3 : y0;
    const long long g = base + r * kRowWords;
    if (vec_ok && g + 4 <= n) {
      *reinterpret_cast<int4*>(out + g) = make_int4(a, b, c, d);
    } else {
      if (g < n) out[g] = a;
      if (g + 1 < n) out[g + 1] = b;
      if (g + 2 < n) out[g + 2] = c;
      if (g + 3 < n) out[g + 3] = d;
    }
  }
}

}  // namespace

extern "C" int debwt_seg_or_tile() { return kTile; }

// words, out: int32[n]. scratch: ceil(n / kTile) + 1 zeroed 64-bit words
// (one descriptor a tile, then the ticket).
extern "C" int debwt_seg_scan_or(const void* words, void* out, long long n,
                                 int stop, int prefix, void* scratch,
                                 void* stream) {
  if (n <= 0 || stop <= 0 || (stop & (stop - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_tiles = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* w = static_cast<const int*>(words);
  int* o = static_cast<int*>(out);
  unsigned long long* desc = static_cast<unsigned long long*>(scratch);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(desc + n_tiles);
  const int vec_ok =
      ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(o)) &
       15) == 0;
  const unsigned grid = static_cast<unsigned>(n_tiles);
  if (prefix) {
    seg_or_scan<true><<<grid, kThreads, 0, s>>>(w, o, n, n_tiles, stop, vec_ok,
                                                desc, ticket);
  } else {
    seg_or_scan<false><<<grid, kThreads, 0, s>>>(w, o, n, n_tiles, stop,
                                                 vec_ok, desc, ticket);
  }
  return static_cast<int>(cudaGetLastError());
}
