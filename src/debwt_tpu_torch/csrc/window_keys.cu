// window_keys: the right-aligned 2-bit key of every w-char window.
//
// Replaces the Pallas TPU kernel
//   src/debwt_tpu/kernels/window_keys.py::window_keys_pallas
// which log-doubles (hi, lo) uint32 key pairs inside (64, 128) VMEM
// tiles with an 8-row halo. Here the key is one uint64 (read by the
// port as int64 with the same 64 bits as (hi << 32) | lo):
//
//   key(p) = sum_{i < w} x[p + i] * 4^(w - 1 - i),   0 <= p < n_out
//
// What bounds it on an H100: bytes, and almost all of them the keys it
// writes: 8 bytes a key against 2 bits a code read (at 140 Mbp: 0.04 GB
// in, 1.34 GB out, 0.41 ms at 3.35 TB/s). A kernel that builds a key
// from w one-byte shared-memory loads is held by the rate of
// shared-memory loads instead (one 32-lane load a clock and SM), so
// this one never touches a code on its own:
//
//   * One body. A block stages its span in shared memory as packed
//     32-bit words, 16 codes a word, first code in bits 31:30 (the
//     layout of ops.pack_2bit_words_host). The key at position p, with
//     j = p >> 4 and o = p & 15, is the top 2w bits of the 64-bit
//     window that starts 2o bits into W[j]: two funnel shifts over
//     W[j], W[j+1], W[j+2] and one right shift. Three shared-memory
//     loads a key, each a broadcast to the 16 threads that share j.
//   * Two loaders. debwt_window_keys_packed copies the words straight
//     from device memory. debwt_window_keys takes uint8 codes, one a
//     byte, at any byte offset (a slice of a tensor), and packs 16 codes
//     into a word while staging: one 16-byte load where the address
//     allows it, byte loads elsewhere.
//   * A word past the end of the input is not read; it stages as 0. A
//     key never depends on it: its window ends at code n_out + w - 2 at
//     the latest, and the caller has that many codes.
//   * Stores are one 8-byte store a key, neighbouring threads on
//     neighbouring keys: 256 contiguous bytes a warp.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md), n_out = 167,772,160,
// w = 32: 0.50 ms from packed words, 0.54 ms from uint8 codes, beside
// 0.41 ms for a plain fill of the keys' bytes; the time no longer
// follows w.
//
// A third entry, debwt_window_keys_at, is the same body at gathered
// positions: out[i] is the key of the w-char window at text position
// pos[i] (int64, any order), read from the packed text. The out-of-core
// tier's pass B calls it on a bucket's rows, whose keys it does not keep
// on disk. One thread a row reads its position, the (at most two) 32-byte
// sectors that hold W[j], W[j+1], W[j+2] straight from device memory
// through the read-only cache, and writes its key: bound by bytes, 8 of
// position in, 8 of key out and a sector of words a row, since a bucket's
// positions lie a few hundred codes apart and share no sector.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kSpan = kThreads * kItems;   // keys per block
constexpr int kWords = kSpan / 16 + 2;     // staged words per block
constexpr int kMaxW = 32;

// Four codes, one a byte, lowest byte first -> c0<<6 | c1<<4 | c2<<2 | c3.
__device__ __forceinline__ unsigned pack4(unsigned r) {
  r &= 0x03030303u;
  return ((r << 6) | (r >> 4) | (r >> 14) | (r >> 24)) & 0xffu;
}

struct PackedLoader {
  const unsigned* words;
  long long n_words;
  // word `g` of the packed text
  __device__ __forceinline__ unsigned operator()(long long g) const {
    return g < n_words ? words[g] : 0u;
  }
};

struct ByteLoader {
  const uint8_t* x;
  long long n_in;
  __device__ __forceinline__ unsigned operator()(long long g) const {
    const long long c = g * 16;
    const uint8_t* p = x + c;
    if (c + 16 <= n_in && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      return (pack4(v.x) << 24) | (pack4(v.y) << 16) | (pack4(v.z) << 8) |
             pack4(v.w);
    }
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const unsigned code = c + i < n_in ? (p[i] & 3u) : 0u;
      word |= code << (30 - 2 * i);
    }
    return word;
  }
};

template <typename Loader>
__global__ void __launch_bounds__(kThreads)
window_keys_kernel(Loader load, unsigned long long* __restrict__ out,
                   long long n_out, int w) {
  __shared__ unsigned s[kWords];
  const long long base = static_cast<long long>(blockIdx.x) * kSpan;
  for (int i = threadIdx.x; i < kWords; i += kThreads) {
    s[i] = load(base / 16 + i);
  }
  __syncthreads();
  const int drop = 2 * (32 - w);     // 0..62 for 1 <= w <= 32
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int o = it * kThreads + threadIdx.x;
    const long long p = base + o;
    if (p < n_out) {
      const int j = o >> 4;
      const unsigned sh = 2u * (o & 15);
      const unsigned w0 = s[j], w1 = s[j + 1], w2 = s[j + 2];
      const unsigned hi = __funnelshift_l(w1, w0, sh);
      const unsigned lo = __funnelshift_l(w2, w1, sh);
      out[p] = ((static_cast<unsigned long long>(hi) << 32) | lo) >> drop;
    }
  }
}

template <typename Loader>
int launch(Loader load, void* out, long long n_out, int w, void* stream) {
  const long long blocks = (n_out + kSpan - 1) / kSpan;
  window_keys_kernel<Loader><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      load, static_cast<unsigned long long*>(out), n_out, w);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(long long n_codes, long long n_out, int w) {
  return w < 1 || w > kMaxW || n_out <= 0 || n_codes < n_out + w - 1;
}

// out[i] = the key of the w-char window at text position pos[i]; a word
// outside [0, n_words) reads as 0, as in PackedLoader.
__global__ void __launch_bounds__(kThreads)
window_keys_at_kernel(const unsigned* __restrict__ words, long long n_words,
                      const long long* __restrict__ pos, long long n,
                      unsigned long long* __restrict__ out, int w) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long p = pos[i];
  const long long j = p >> 4;            // arithmetic: a negative p stays < 0
  const unsigned sh = 2u * static_cast<unsigned>(p & 15);
  unsigned v[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const unsigned long long g = static_cast<unsigned long long>(j + t);
    v[t] = g < static_cast<unsigned long long>(n_words) ? __ldg(words + g) : 0u;
  }
  const unsigned hi = __funnelshift_l(v[1], v[0], sh);
  const unsigned lo = __funnelshift_l(v[2], v[1], sh);
  out[i] = ((static_cast<unsigned long long>(hi) << 32) | lo) >> (2 * (32 - w));
}

}  // namespace

// x: uint8[n_in] codes 0..3 at any byte address; out: uint64[n_out].
extern "C" int debwt_window_keys(const void* x, long long n_in, void* out,
                                 long long n_out, int w, void* stream) {
  if (bad_args(n_in, n_out, w)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ByteLoader{static_cast<const uint8_t*>(x), n_in}, out, n_out,
                w, stream);
}

// words: uint32[n_words], 16 codes a word, first code in bits 31:30.
extern "C" int debwt_window_keys_packed(const void* words, long long n_words,
                                        void* out, long long n_out, int w,
                                        void* stream) {
  if (bad_args(16 * n_words, n_out, w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(PackedLoader{static_cast<const unsigned*>(words), n_words}, out,
                n_out, w, stream);
}

// words: uint32[n_words] as above; pos: int64[n] text positions;
// out: uint64[n].
extern "C" int debwt_window_keys_at(const void* words, long long n_words,
                                    const void* pos, long long n, int w,
                                    void* out, void* stream) {
  if (w < 1 || w > kMaxW || n <= 0 || n_words <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  window_keys_at_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), n_words,
      static_cast<const long long*>(pos), n,
      static_cast<unsigned long long*>(out), w);
  return static_cast<int>(cudaGetLastError());
}
