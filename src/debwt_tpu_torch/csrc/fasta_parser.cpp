// Native FASTA parser + 2-bit encoder.
//
// The reference's ingest is the kseq.h C header library
// (src/kseq.h, used by src/collect#$.c:27-90); this is its native fast
// path: one pass over the raw byte buffer, branch-light, emitting
// per-read code arrays (0..3) and record boundaries. The port's own
// copy of the JAX package's csrc/fasta_parser.cpp, built with the host
// C++ compiler at first use (kernels/_build.py) and bound with ctypes
// (debwt_tpu_torch/io/native.py). A host helper, not a GPU kernel.
//
// Policies: 0 = reject non-ACGT, 2 = map N/n to G (the src/mySort.c:33
// quirk; other IUPAC codes still reject). Policy 1 (seeded random
// substitution) stays in NumPy so the substitution stream is identical
// across code paths.

#include <cstdint>
#include <cstring>

namespace {

// 0..3 = base code, 0xFE = N (for policy 2), 0xFF = invalid
uint8_t make_entry(char c) {
    switch (c) {
        case 'A': case 'a': return 0;
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': return 3;
        case 'N': case 'n': return 0xFE;
        default: return 0xFF;
    }
}

struct Lut {
    uint8_t v[256];
    Lut() {
        for (int i = 0; i < 256; i++) v[i] = make_entry(static_cast<char>(i));
    }
};
const Lut LUT;

}  // namespace

extern "C" {

// Returns 0 on success; negative error codes otherwise.
//  -1 buffer does not start with '>'
//  -2 invalid character (position reported via *err_pos)
//  -3 record overflow (n_records_cap too small)
// Outputs:
//  out_codes      caller buffer of at least buf_len bytes
//  out_bounds     caller buffer of n_records_cap+1 int64 (record ends
//                 as exclusive prefix offsets into out_codes)
//  *n_records    number of records parsed
//  *total_codes  total encoded bases
int debwt_parse_fasta(const uint8_t* buf, int64_t buf_len, int policy,
                      uint8_t* out_codes, int64_t* out_bounds,
                      int64_t n_records_cap, int64_t* n_records,
                      int64_t* total_codes, int64_t* err_pos) {
    if (buf_len <= 0 || buf[0] != '>') return -1;
    int64_t w = 0;        // write cursor into out_codes
    int64_t rec = -1;     // current record index
    int64_t i = 0;
    while (i < buf_len) {
        if (buf[i] == '>') {
            if (rec >= 0) out_bounds[rec + 1] = w;
            rec++;
            if (rec >= n_records_cap) return -3;
            if (rec == 0) out_bounds[0] = 0;
            // skip header line
            while (i < buf_len && buf[i] != '\n') i++;
            i++;
            continue;
        }
        // sequence line
        while (i < buf_len && buf[i] != '\n') {
            uint8_t c = buf[i];
            if (c == '\r') { i++; continue; }
            uint8_t v = LUT.v[c];
            if (v <= 3) {
                out_codes[w++] = v;
            } else if (v == 0xFE && policy == 2) {
                out_codes[w++] = 2;  // N -> G quirk
            } else {
                *err_pos = i;
                return -2;
            }
            i++;
        }
        i++;
    }
    if (rec >= 0) out_bounds[rec + 1] = w;
    *n_records = rec + 1;
    *total_codes = w;
    return 0;
}

}  // extern "C"
