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
// What bounds it on an H100: bytes. Each output costs one code byte
// read and eight key bytes written (at 140 Mbp: ~0.17 GB in, 1.34 GB
// out, ~0.45 ms at 3.35 TB/s); the w shifted ORs per key are far below
// the integer issue rate.
//
// Design: one block stages its span of kSpan codes plus a (w - 1)-code
// halo in shared memory with coalesced byte loads, so every code is
// read from device memory once per block; each thread then assembles
// kItems keys from shared memory (neighbouring threads read
// neighbouring bytes: broadcasts, no bank conflicts) and writes them
// coalesced, one 8-byte store per key. Reading the 2-bit packed words
// directly (fusing the unpack in front of it) is left for later.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kSpan = kThreads * kItems;  // keys per block
constexpr int kMaxW = 32;

__global__ void __launch_bounds__(kThreads)
window_keys_kernel(const uint8_t* __restrict__ x, long long n_in,
                   unsigned long long* __restrict__ out, long long n_out,
                   int w) {
  __shared__ uint8_t s[kSpan + kMaxW];
  const long long base = static_cast<long long>(blockIdx.x) * kSpan;
  const int need = kSpan + w - 1;
  for (int i = threadIdx.x; i < need; i += kThreads) {
    const long long g = base + i;
    s[i] = g < n_in ? x[g] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int o = j * kThreads + threadIdx.x;
    const long long p = base + o;
    if (p < n_out) {
      unsigned long long key = 0;
      for (int i = 0; i < w; ++i) {
        key = (key << 2) | s[o + i];
      }
      out[p] = key;
    }
  }
}

}  // namespace

extern "C" int debwt_window_keys(const void* x, long long n_in, void* out,
                                 long long n_out, int w, void* stream) {
  if (w < 1 || w > kMaxW || n_out <= 0 || n_in < n_out + w - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n_out + kSpan - 1) / kSpan;
  window_keys_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), n_in,
      static_cast<unsigned long long*>(out), n_out, w);
  return static_cast<int>(cudaGetLastError());
}
