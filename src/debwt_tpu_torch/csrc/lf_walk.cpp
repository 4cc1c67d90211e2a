// Native LF backward-walk kernels for BWT verification.
//
// The reference's dev-mode verification (src/LFsearch.c:49-235) walks
// the BWT backwards one step at a time — an inherently sequential
// permutation chase that a Python loop runs at ~1M steps/s. These
// kernels run the same walk at memory-chase speed (tens of M steps/s),
// making full-text verification practical at the 140 Mbp - 3 Gbp
// tiers. The port's own copy of the JAX package's csrc/lf_walk.cpp,
// built with the host C++ compiler at first use (kernels/_build.py)
// and bound with ctypes (debwt_tpu_torch/io/native.py). A host helper,
// not a GPU kernel.
//
// Two variants, mirroring verify.py's two memory regimes:
//   debwt_lf_walk      precomputed LF permutation (8N bytes) — fast path
//   debwt_lf_walk_occ  sampled occ table (the reference's 1-in-32
//                      sampling, src/insertCase3.c:158-193) — bounded
//                      memory for the 30 Gbp tier

#include <cstdint>

extern "C" {

// Walk `steps` steps of i <- lf[i] starting at `start`, checking
// bwt6[i] == x6[pos] for pos = n-1, n-2, ...
// Returns -1 on success, else the text position of the first mismatch.
int64_t debwt_lf_walk(const int64_t* lf, const uint8_t* bwt6,
                      const uint8_t* x6, int64_t n, int64_t steps,
                      int64_t start) {
    int64_t i = start;
    for (int64_t pos = n - 1; pos > n - 1 - steps; --pos) {
        if (x6[pos] != bwt6[i]) return pos;
        i = lf[i];
    }
    return -1;
}

// Same walk via the sampled occ table: occ6[(n/sample+1) x 6] counts
// each char in bwt6[: j*sample]; cum[7] is the exclusive char-base
// prefix (cum[c] = #chars < c in the whole BWT). occ6 entries are
// uint32 when counts fit (occ_is_u32 != 0), else int64.
int64_t debwt_lf_walk_occ(const uint8_t* bwt6, const uint8_t* x6,
                          const void* occ6, int occ_is_u32,
                          const int64_t* cum, int64_t sample,
                          int64_t n, int64_t steps, int64_t start) {
    const uint32_t* occ32 = static_cast<const uint32_t*>(occ6);
    const int64_t* occ64 = static_cast<const int64_t*>(occ6);
    int64_t i = start;
    for (int64_t pos = n - 1; pos > n - 1 - steps; --pos) {
        uint8_t c = bwt6[i];
        if (x6[pos] != c) return pos;
        int64_t blk = i / sample;
        int64_t r = occ_is_u32 ? static_cast<int64_t>(occ32[blk * 6 + c])
                               : occ64[blk * 6 + c];
        for (int64_t j = blk * sample; j < i; ++j) r += (bwt6[j] == c);
        i = cum[c] + r;
    }
    return -1;
}

}  // extern "C"
