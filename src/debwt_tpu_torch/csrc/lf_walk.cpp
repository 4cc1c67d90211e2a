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
// and the occ table itself, debwt_occ6 (the port's own addition: one
// pass over the BWT, where verify._build_occ6_numpy's blocked cumsum
// takes a minute at 600 Mbp).

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

// The sampled occ table of verify._build_occ6_numpy: row j of occ6
// ((n_s + 1) x 6, n_s = ceil(n / sample)) counts each of the six chars
// in bwt6[: min(n, j * sample)]; counts6 gets the totals. Entries are
// uint32 when occ_is_u32 != 0 (the caller's choice for n < 2^32), else
// int64. A byte over 5 is counted nowhere, as in the NumPy version.
void debwt_occ6(const uint8_t* bwt6, int64_t n, int64_t sample,
                void* occ6, int occ_is_u32, int64_t* counts6) {
    uint32_t* occ32 = static_cast<uint32_t*>(occ6);
    int64_t* occ64 = static_cast<int64_t*>(occ6);
    int64_t c[256] = {0};
    const int64_t n_s = (n + sample - 1) / sample;
    for (int64_t j = 0; j <= n_s; ++j) {
        if (j) {
            const int64_t end = j * sample < n ? j * sample : n;
            for (int64_t i = (j - 1) * sample; i < end; ++i) ++c[bwt6[i]];
        }
        for (int k = 0; k < 6; ++k) {
            if (occ_is_u32)
                occ32[j * 6 + k] = static_cast<uint32_t>(c[k]);
            else
                occ64[j * 6 + k] = c[k];
        }
    }
    for (int k = 0; k < 6; ++k) counts6[k] = c[k];
}

}  // extern "C"
