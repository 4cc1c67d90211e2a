// Native FASTA parser + 2-bit encoder.
//
// The reference's ingest is the kseq.h C header library
// (src/kseq.h, used by src/collect#$.c:27-90); this is its native fast
// path. The port's own copy of the JAX package's csrc/fasta_parser.cpp,
// built with the host C++ compiler at first use (kernels/_build.py) and
// bound with ctypes (debwt_tpu_torch/io/native.py). A host helper, not a
// GPU kernel. Two entries:
//
//   debwt_parse_fasta        io.read_fasta's whole-file parse: one pass
//                            over the raw bytes, emitting per-read code
//                            arrays (0..3) and record boundaries.
//   debwt_scan_fasta_region  io.read_collection's streaming pass: one
//                            region of whole lines at a time, written
//                            straight into the collection's x2 (codes,
//                            and a T (3) where each record ends) and its
//                            separator positions.
//
// Policies: 0 = reject non-ACGT, 2 = map N/n to G (the src/mySort.c:33
// quirk; other IUPAC codes still reject). Policy 1 (seeded random
// substitution) draws its bases in NumPy so the substitution stream is
// identical across code paths; the region scan only marks its bytes.

#include <cstdint>
#include <cstring>
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

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

// The region scan's tables, one a policy: 0..3 = base code, CR = a byte
// dropped, 0xFF = invalid. Under policy 2 N/n are 2; under policy 1 an
// IUPAC ambiguity code (either case; io.fasta.IUPAC's keys) is its
// upper-case letter, which io.fasta replaces with a drawn base.
constexpr uint8_t CR = 0xFE;
constexpr uint8_t BAD = 0xFF;

struct ScanLut {
    uint8_t v[3][256];
    ScanLut() {
        for (int p = 0; p < 3; p++) {
            for (int i = 0; i < 256; i++) {
                uint8_t e = make_entry(static_cast<char>(i));
                v[p][i] = e <= 3 ? e : BAD;
            }
            v[p]['\r'] = CR;
        }
        v[2]['N'] = v[2]['n'] = 2;
        for (const char* c = "RYSWKMBDHVN"; *c; c++) {
            v[1][static_cast<uint8_t>(*c)] = static_cast<uint8_t>(*c);
            v[1][static_cast<uint8_t>(*c + 32)] = static_cast<uint8_t>(*c);
        }
    }
};
const ScanLut SCAN;

// A line body's codes into out, when every byte is one of ACGTacgt (or
// a byte the table t codes 0..3): one branch a line, or a 16-byte block
// with SSE2, whose ((c >> 1) ^ (c >> 2)) & 3 is the code of each of
// ACGTacgt. false, and out unspecified, when any other byte is there.
bool fast_line(const uint8_t* __restrict__ p, int64_t n, const uint8_t* t,
               uint8_t* __restrict__ out) {
    int64_t j = 0;
#if defined(__SSE2__)
    const __m128i lower = _mm_set1_epi8(0x20), three = _mm_set1_epi8(3);
    for (; j + 16 <= n; j += 16) {
        __m128i c = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + j));
        __m128i l = _mm_or_si128(c, lower);
        __m128i ok = _mm_or_si128(
            _mm_or_si128(_mm_cmpeq_epi8(l, _mm_set1_epi8('a')),
                         _mm_cmpeq_epi8(l, _mm_set1_epi8('c'))),
            _mm_or_si128(_mm_cmpeq_epi8(l, _mm_set1_epi8('g')),
                         _mm_cmpeq_epi8(l, _mm_set1_epi8('t'))));
        if (_mm_movemask_epi8(ok) != 0xFFFF) return false;
        __m128i v = _mm_and_si128(
            _mm_xor_si128(_mm_srli_epi16(c, 1), _mm_srli_epi16(c, 2)), three);
        _mm_storeu_si128(reinterpret_cast<__m128i*>(out + j), v);
    }
#endif
    uint8_t acc = 0;
    for (; j < n; j++) {
        uint8_t v = t[p[j]];
        out[j] = v;
        acc |= v;
    }
    return acc <= 3;
}

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

// One region of whole lines ('\n'-terminated), appended to x2 at
// *cursor. A line that starts with '>' is a header: it closes the open
// record (*open), writing T at the cursor and its position into sep. Any
// other line is a body: its bytes through the policy's table, CRs
// dropped; a line of ACGTacgt only (no CR but a last one, no N, no
// invalid byte) takes fast_line's one branch, not one a byte; any other
// line is coded again a byte at a time. With `last`, the open record
// is closed after the region, so that sep ends at the text's last
// position. Returns
//   0  the region done: *consumed = len;
//   1  x2 or sep too small for the next line: *consumed bytes (whole
//      lines) are done; grow and call again on the rest;
//  -2  an invalid byte, *err_byte, in body order.
// *n_marked counts the IUPAC bytes policy 1 left marked in x2.
int debwt_scan_fasta_region(const uint8_t* __restrict__ buf, int64_t len,
                            int policy, int last,
                            uint8_t* __restrict__ x2, int64_t x2_cap,
                            int64_t* cursor, int64_t* sep, int64_t sep_cap,
                            int64_t* n_sep, int* open, int64_t* consumed,
                            int64_t* n_marked, int* err_byte) {
    const uint8_t* t = SCAN.v[policy];
    int64_t w = *cursor, ns = *n_sep, marked = 0, i = 0;
    int rc = 0;
    while (i < len) {
        const uint8_t* nl = static_cast<const uint8_t*>(
            std::memchr(buf + i, '\n', static_cast<size_t>(len - i)));
        int64_t e = nl ? nl - buf : len;
        if (buf[i] == '>') {
            if (*open) {
                if (w >= x2_cap || ns >= sep_cap) { rc = 1; break; }
                sep[ns++] = w;
                x2[w++] = 3;
            }
            *open = 1;
        } else {
            int64_t n = e - i;
            const uint8_t* p = buf + i;
            if (n > 0 && p[n - 1] == '\r') n--;
            if (w + n > x2_cap) { rc = 1; break; }
            if (fast_line(p, n, t, x2 + w)) {
                w += n;
            } else {
                for (int64_t j = 0; j < n; j++) {
                    uint8_t v = t[p[j]];
                    if (v == CR) continue;
                    if (v == BAD) {
                        *err_byte = p[j];
                        rc = -2;
                        break;
                    }
                    marked += v > 3;
                    x2[w++] = v;
                }
                if (rc) break;
            }
        }
        i = e + 1;
    }
    if (rc == 0 && i > len) i = len;
    if (rc == 0 && last && *open) {
        if (w >= x2_cap || ns >= sep_cap) {
            rc = 1;
        } else {
            sep[ns++] = w;
            x2[w++] = 3;
            *open = 0;
        }
    }
    *cursor = w;
    *n_sep = ns;
    *consumed = i;
    *n_marked += marked;
    return rc;
}

}  // extern "C"
