// Native CSV tokenizer — the hot byte-scanning loop of ingest.
//
// Reference role: water/parser/CsvParser.java streams raw-byte chunks
// into NewChunks inside MultiFileParseTask (ParseDataset.java:623); the
// tokenizer is the CPU-bound inner loop of every import. Here the same
// loop is C++ behind a C ABI (ctypes binding in h2o3_tpu/native/
// __init__.py), emitting per-cell byte offsets plus eagerly-parsed
// doubles; Python only touches the (rare) non-numeric cells.
//
// Scope: separator-delimited rows, '\n'/'\r\n'
// terminators, RFC-4180 quoted fields (embedded separators, embedded
// newlines, "" escapes), numeric tokens of any length (in-place strtod
// — no copy, no 63-char cap), and unicode-whitespace trimming that
// byte-matches Python's str.strip() on UTF-8 input. The caller scans a
// borrowed buffer (an mmap view — zero copy), and cell values land
// COLUMN-major (idx = col*rows + row) so each finished column is one
// contiguous slice.
//
// Equivalence contract: a cell the Python tokenizer (csv.reader +
// str.strip + float) would produce must come out bit-identical here —
// the range-scoped fallback in ingest/parse.py mixes tokenizers across
// byte ranges of the SAME column, so any divergence corrupts frames
// silently. Numeric acceptance therefore mirrors Python float(): a
// strict [0-9+-.eE] / inf / nan character filter runs before strtod so
// C-isms Python rejects (hex floats "0x1A", "NAN(tag)") stay
// non-numeric, and PEP-515 digit-group underscores ("1_000") parse via
// their stripped form exactly as float() would. Known residual
// divergence (documented, exotic): Python float() also accepts
// non-ASCII unicode digits; those parse as NA here.
//
// Declines are *reasons*, not booleans: ragged rows, a quote left open
// at the end of the range, or non-whitespace trailing a closing quote
// return a reason code and ONLY that byte range re-parses through the
// Python tokenizer (parse.py fallback seam).
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

inline unsigned long long fnv1a(const char* p, int n) {
    unsigned long long h = 1469598103934665603ULL;
    for (int i = 0; i < n; ++i) {
        h ^= (unsigned char)p[i];
        h *= 1099511628211ULL;
    }
    return h;
}

// ---- unicode-whitespace trim (byte-level mirror of str.strip()) ------
//
// Python's str.strip() removes every codepoint where str.isspace() is
// true. On UTF-8 bytes that is: the ASCII set below, plus the exact
// multi-byte sequences for U+0085 U+00A0 U+1680 U+2000..200A U+2028
// U+2029 U+202F U+205F U+3000. (U+200B ZWSP is NOT whitespace.)

inline bool ascii_ws(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v'
        || c == '\f' || (c >= 0x1c && c <= 0x1f);
}

// byte length of one whitespace char starting at p (0 = not whitespace)
inline int ws_fwd(const unsigned char* p, long long n) {
    unsigned char c = p[0];
    if (ascii_ws(c)) return 1;
    if (c == 0xC2 && n >= 2 && (p[1] == 0x85 || p[1] == 0xA0)) return 2;
    if (n >= 3) {
        if (c == 0xE1 && p[1] == 0x9A && p[2] == 0x80) return 3;
        if (c == 0xE2) {
            if (p[1] == 0x80 && ((p[2] >= 0x80 && p[2] <= 0x8A)
                                 || p[2] == 0xA8 || p[2] == 0xA9
                                 || p[2] == 0xAF)) return 3;
            if (p[1] == 0x81 && p[2] == 0x9F) return 3;
        }
        if (c == 0xE3 && p[1] == 0x80 && p[2] == 0x80) return 3;
    }
    return 0;
}

// byte length of one whitespace char ENDING at e (exclusive); s bounds
// the lookback. Exact-pattern matches are unambiguous across lengths.
inline int ws_back(const unsigned char* s, const unsigned char* e) {
    long long n = e - s;
    unsigned char c = e[-1];
    if (ascii_ws(c)) return 1;
    if (n >= 3) {
        unsigned char a = e[-3], b = e[-2];
        if (a == 0xE1 && b == 0x9A && c == 0x80) return 3;
        if (a == 0xE2 && b == 0x80 && ((c >= 0x80 && c <= 0x8A)
                                       || c == 0xA8 || c == 0xA9
                                       || c == 0xAF)) return 3;
        if (a == 0xE2 && b == 0x81 && c == 0x9F) return 3;
        if (a == 0xE3 && b == 0x80 && c == 0x80) return 3;
    }
    if (n >= 2 && e[-2] == 0xC2 && (c == 0x85 || c == 0xA0)) return 2;
    return 0;
}

// ---- numeric acceptance: the Python float() shape -------------------

// every byte in [0-9 + - . e E] — the only tokens handed to strtod
// besides the inf/nan words, so strtod's wider grammar (hex, NAN(tag))
// can never diverge from what float() would accept
inline bool numeric_chars(const char* p, long long n) {
    for (long long i = 0; i < n; ++i) {
        char c = p[i];
        if (!((c >= '0' && c <= '9') || c == '+' || c == '-' || c == '.'
              || c == 'e' || c == 'E')) return false;
    }
    return true;
}

// PEP-515 underscore grouping: Python float("1_000.5") == 1000.5, with
// every '_' strictly BETWEEN two digits. Tokens passing this check are
// re-parsed with the underscores stripped, so a numeric column mixing
// tokenizers across byte ranges (range-scoped fallback) cannot read
// '1_000' as NA natively and 1000.0 in Python. Returns the stripped
// length, or -1 when the token is not a valid grouped numeric.
inline long long strip_underscores(const char* p, long long n,
                                   char* out, long long cap) {
    if (n >= cap) return -1;
    long long m = 0;
    bool saw = false;
    for (long long i = 0; i < n; ++i) {
        char c = p[i];
        if (c == '_') {
            saw = true;
            if (i == 0 || i + 1 >= n) return -1;
            char a = p[i - 1], b = p[i + 1];
            if (!(a >= '0' && a <= '9') || !(b >= '0' && b <= '9'))
                return -1;
            continue;
        }
        if (!((c >= '0' && c <= '9') || c == '+' || c == '-' || c == '.'
              || c == 'e' || c == 'E')) return -1;
        out[m++] = c;
    }
    if (!saw) return -1;   // no underscores: take the normal path
    out[m] = 0;
    return m;
}

inline bool ieq(char a, char b) { return (a | 0x20) == b; }

// [+-]? (inf | infinity | nan), case-insensitive — strtod and float()
// agree on these
inline bool inf_nan_form(const char* p, long long n) {
    if (n > 0 && (p[0] == '+' || p[0] == '-')) { ++p; --n; }
    if (n == 3) {
        if (ieq(p[0], 'i') && ieq(p[1], 'n') && ieq(p[2], 'f')) return true;
        if (ieq(p[0], 'n') && ieq(p[1], 'a') && ieq(p[2], 'n')) return true;
    }
    if (n == 8) {
        const char* w = "infinity";
        for (int i = 0; i < 8; ++i) if (!ieq(p[i], w[i])) return false;
        return true;
    }
    return false;
}

// Clinger fast path: when the token is [+-]?digits[.digits][eE[+-]digits]
// with <= 19 digits, mantissa < 2^53 and |decimal exponent| <= 22, both
// the mantissa and the power of ten are EXACT doubles, so one multiply
// (or divide) performs the single correctly-rounded step — bit-identical
// to strtod, ~15x faster (strtod was the tokenize bottleneck: ~50 MB/s
// per core on an all-numeric CSV). Returns false to fall back.
const double P10[] = {1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9,
                      1e10, 1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17,
                      1e18, 1e19, 1e20, 1e21, 1e22};

inline bool fast_atod(const char* p, long long n, double* out) {
    bool neg = false;
    long long i = 0;
    if (i < n && (p[i] == '+' || p[i] == '-')) { neg = p[i] == '-'; ++i; }
    unsigned long long mant = 0;
    int digits = 0, frac = 0;
    bool seen_dot = false, any = false;
    for (; i < n; ++i) {
        char c = p[i];
        if (c >= '0' && c <= '9') {
            if (digits >= 19) return false;
            ++digits;
            mant = mant * 10 + (unsigned long long)(c - '0');
            if (seen_dot) ++frac;
            any = true;
        } else if (c == '.') {
            if (seen_dot) return false;
            seen_dot = true;
        } else {
            break;
        }
    }
    if (!any) return false;
    long long e = 0;
    if (i < n && (p[i] == 'e' || p[i] == 'E')) {
        ++i;
        bool eneg = false;
        if (i < n && (p[i] == '+' || p[i] == '-')) { eneg = p[i] == '-'; ++i; }
        if (i >= n) return false;
        long long ev = 0;
        for (; i < n; ++i) {
            char c = p[i];
            if (c < '0' || c > '9') return false;
            ev = ev * 10 + (c - '0');
            if (ev > 9999) return false;
        }
        e = eneg ? -ev : ev;
    }
    if (i != n) return false;
    e -= frac;
    if (mant >= (1ULL << 53)) return false;
    double d;
    if (e >= 0) {
        if (e > 22) return false;
        d = (double)mant * P10[e];
    } else {
        if (e < -22) return false;
        d = (double)mant / P10[-e];
    }
    *out = neg ? -d : d;
    return true;
}

// decline reasons shared by csv_parse / the binding
enum { DECLINE_OK = 0, DECLINE_RAGGED = 1, DECLINE_OPEN_QUOTE = 2,
       DECLINE_TRAILING_QUOTE = 3 };

// Strict UTF-8 validation (rejects overlongs, surrogates, > U+10FFFF).
// Used by csv_enum_encode_full: byte-lexicographic order over VALID
// UTF-8 equals Python's code-point order over the decoded strings, so
// the native sort can stand in for sorted() on the domain — any invalid
// label instead declines the whole column back to the Python path
// (whose errors='replace' decode has no byte-order guarantee).
inline bool valid_utf8(const unsigned char* p, long long n) {
    long long i = 0;
    while (i < n) {
        unsigned char c = p[i];
        if (c < 0x80) { ++i; continue; }
        int k;
        if ((c & 0xE0) == 0xC0) k = 1;
        else if ((c & 0xF0) == 0xE0) k = 2;
        else if ((c & 0xF8) == 0xF0) k = 3;
        else return false;
        if (i + k >= n) return false;
        for (int j = 1; j <= k; ++j)
            if ((p[i + j] & 0xC0) != 0x80) return false;
        if (k == 1 && c < 0xC2) return false;                   // overlong
        if (k == 2) {
            if (c == 0xE0 && p[i + 1] < 0xA0) return false;     // overlong
            if (c == 0xED && p[i + 1] >= 0xA0) return false;    // surrogate
        }
        if (k == 3) {
            if (c == 0xF0 && p[i + 1] < 0x90) return false;     // overlong
            if (c > 0xF4 || (c == 0xF4 && p[i + 1] >= 0x90))
                return false;                                   // > U+10FFFF
        }
        i += k + 1;
    }
    return true;
}

}  // namespace

extern "C" {

// The single scan pass: per-cell start offsets + lengths (content
// between quotes for quoted cells; unicode-whitespace-trimmed both
// ways) and an eager in-place numeric parse, through the full
// quote-aware state machine. The caller supplies the expected column
// count (from ParseSetup) and a row-count UPPER BOUND (its newline
// count + 1 — embedded quoted newlines only ever make the true row
// count smaller); the scan itself validates widths, so no separate
// shape pass walks the bytes twice. Returns the rows actually filled,
// or -1 with *reason_out set: inconsistent row widths, a quote still
// open at the end of the range, or non-whitespace text after a closing
// quote (csv.reader glues it into the field — offsets can't express
// that). Quotes open ONLY as a cell's first byte, exactly like
// csv.reader with skipinitialspace off.
//
// Output arrays are caller-allocated with rows_cap*ncols entries, laid
// out COLUMN-major with rows_cap as the stride: idx = col*rows_cap +
// row, so each column's filled prefix is one contiguous slice.
//
// ok[idx] low bits: 1 = numeric (vals[idx] holds the value), 0 =
// non-numeric text, 2 = empty cell; bit 0x80 = the (quoted) cell
// contains "" escape sequences — its raw bytes need one
// replace("\"\"" -> "\"") before use as a token.
//
// The numeric parse runs IN PLACE on the borrowed buffer (fast_atod,
// strtod fallback): tokens handed to strtod are pre-filtered to numeric
// characters and the byte at p+n is always a delimiter/whitespace/
// quote, so the parse cannot run past the token — except when the
// token touches the very end of the buffer (an mmap of a file ending
// without a newline may not be readable one byte past EOF), where it
// copies through a small stack buffer instead.
// ``want_offsets`` (len ncols, NULL = all) suppresses the starts/lens
// writes per column: a float64 column's offsets are never read back
// (its value IS vals[idx]), and skipping them skips ~12B/cell of write
// traffic AND the page faults of the untouched arena region — on a
// mostly-numeric file that halves the scan's memory traffic.
long long csv_parse(const char* buf, long long len, char sep, char quote,
                    long long rows_cap, long long ncols,
                    const unsigned char* want_offsets,
                    long long* starts, int* lens, double* vals,
                    unsigned char* ok, long long* reason_out,
                    long long* esc_count_out) {
    const long long rows = rows_cap;  // column stride
    long long r = 0, cidx = 0;
    long long esc_cells = 0;
    long long cell_start = 0;
    long long qs = -1, qe = -1;   // quoted-content span of the current cell
    bool esc = false;             // current quoted cell has "" escapes
    bool any = false, at_start = true;
    const unsigned char* ub = (const unsigned char*)buf;
    *reason_out = DECLINE_OK;
    *esc_count_out = 0;
    auto close_cell = [&](long long end) {
        if (r >= rows || cidx >= ncols) return;
        long long s, e;
        bool escaped = false;
        if (qs >= 0) { s = qs; e = qe; escaped = esc; qs = qe = -1; esc = false; }
        else { s = cell_start; e = end; }
        while (s < e) {
            int k = ws_fwd(ub + s, e - s);
            if (!k) break;
            s += k;
        }
        while (e > s) {
            int k = ws_back(ub + s, ub + e);
            if (!k) break;
            e -= k;
        }
        long long idx = cidx * rows + r;         // column-major
        long long n = e - s;
        if (!want_offsets || want_offsets[cidx]) {
            starts[idx] = s;
            lens[idx] = (int)n;
        }
        if (n > 0) {
            const char* p = buf + s;
            bool cand = numeric_chars(p, n) || inf_nan_form(p, n);
            double v = NAN;
            bool is_num = false;
            if (!cand && n < 511) {
                // PEP-515 grouped numerics ("1_000"): float() accepts
                // them, so the stripped form must parse here too
                char tmp[512];
                long long m = strip_underscores(p, n, tmp, 512);
                if (m > 0) {
                    if (fast_atod(tmp, m, &v)) {
                        is_num = true;
                    } else {
                        char* endp = nullptr;
                        v = strtod(tmp, &endp);
                        is_num = (endp == tmp + m);
                        if (!is_num) v = NAN;
                    }
                }
            }
            if (is_num) {
                // grouped-numeric path above already parsed the value
            } else if (cand && fast_atod(p, n, &v)) {
                is_num = true;
            } else if (cand) {
                char* endp = nullptr;
                if (e < len) {                    // delimiter byte stops strtod
                    v = strtod(p, &endp);
                    is_num = (endp == p + n);
                } else {                          // token touches buffer end
                    char tmp[512];
                    if (n < 511) {
                        memcpy(tmp, p, n);
                        tmp[n] = 0;
                        v = strtod(tmp, &endp);
                        is_num = (endp == tmp + n);
                    } else {
                        std::vector<char> big(p, p + n);
                        big.push_back(0);
                        v = strtod(big.data(), &endp);
                        is_num = (endp == big.data() + n);
                    }
                }
            }
            vals[idx] = is_num ? v : NAN;
            ok[idx] = is_num ? 1 : 0;
        } else {
            vals[idx] = NAN;
            ok[idx] = 2;                          // empty cell
        }
        if (escaped) { ok[idx] |= 0x80; ++esc_cells; }
    };
    long long i = 0;
    while (i < len && r < rows) {
        char c = buf[i];
        if (c == quote && at_start) {
            qs = i + 1; esc = false;
            ++i;
            for (;;) {
                if (i >= len) {
                    *reason_out = DECLINE_OPEN_QUOTE;
                    return -1;
                }
                if (buf[i] == quote) {
                    if (i + 1 < len && buf[i + 1] == quote) { esc = true; i += 2; continue; }
                    qe = i; ++i; break;
                }
                ++i;
            }
            any = true; at_start = false;
            while (i < len && buf[i] != sep && buf[i] != '\n') {
                char t = buf[i];
                if (t != ' ' && t != '\t' && t != '\r') {
                    *reason_out = DECLINE_TRAILING_QUOTE;
                    return -1;
                }
                ++i;
            }
            continue;                            // i sits on sep/'\n'/EOF
        }
        if (c == '\n') {
            if (any || cidx > 0) {
                if (cidx + 1 != ncols) { *reason_out = DECLINE_RAGGED; return -1; }
                close_cell(i);
                ++r;
            }
            cidx = 0; cell_start = i + 1; any = false; at_start = true;
        } else if (c == sep) {
            close_cell(i);
            ++cidx;
            if (cidx >= ncols) { *reason_out = DECLINE_RAGGED; return -1; }
            cell_start = i + 1; at_start = true;
        } else {
            if (c != '\r') any = true;
            at_start = false;
        }
        ++i;
    }
    if ((any || cidx > 0 || qs >= 0) && r < rows) {
        if (cidx + 1 != ncols) { *reason_out = DECLINE_RAGGED; return -1; }
        close_cell(len);
        ++r;
    }
    *esc_count_out = esc_cells;
    return r;
}

// Range-boundary discovery: one pass of the SAME quote state machine,
// writing the first safe row boundary (offset just past a newline that
// is outside any quoted field) at or after each ascending target.
// parse.py splits files on these so a quoted field with embedded
// newlines can never straddle two byte ranges. Returns the number of
// bounds written (may be < n_targets when targets fall past the last
// outside-quote newline; bounds_out entries are ascending, deduped by
// the caller).
long long csv_chunk_bounds(const char* buf, long long len, char sep,
                           char quote, const long long* targets,
                           long long n_targets, long long* bounds_out) {
    long long t = 0, filled = 0;
    bool at_start = true;
    long long i = 0;
    while (i < len && t < n_targets) {
        char c = buf[i];
        if (c == quote && at_start) {
            ++i;
            for (;;) {
                if (i >= len) return filled;     // open quote: no more bounds
                if (buf[i] == quote) {
                    if (i + 1 < len && buf[i + 1] == quote) { i += 2; continue; }
                    ++i; break;
                }
                ++i;
            }
            at_start = false;
            continue;
        }
        if (c == '\n') {
            at_start = true;
            while (t < n_targets && i >= targets[t]) {
                bounds_out[filled++] = i + 1;
                ++t;
            }
        } else if (c == sep) {
            at_start = true;
        } else {
            at_start = false;
        }
        ++i;
    }
    return filled;
}

// Chunk-local enum dictionary encode (the NewChunk categorical path of
// water/parser/CsvParser.java, where each chunk builds its own domain
// before ParseDataset unions them). One column's cells arrive as
// (starts, lens) pairs from csv_parse; tokens dictionary-encode against
// an open-addressing hash table in first-appearance order. Outputs:
// codes[i] = dictionary id of cell i, uniq_rows[k] = row index of the
// first cell holding dictionary entry k (the caller decodes labels from
// those). Returns the cardinality, or -1 when it would exceed max_card
// (caller falls back to a string column). NA-string, empty-cell and
// ""-escape handling stay in Python: they become ordinary dictionary
// entries the caller remaps/dedupes on the decoded label.
long long csv_enum_encode(const char* buf,
                          const long long* starts, const int* lens,
                          long long n,
                          int* codes, long long* uniq_rows,
                          long long max_card) {
    long long cap = 1024;
    std::vector<long long> table(cap, -1);
    long long card = 0;
    for (long long i = 0; i < n; ++i) {
        if (card * 10 >= cap * 7) {          // load > 0.7: rehash
            cap <<= 1;
            table.assign(cap, -1);
            for (long long k = 0; k < card; ++k) {
                long long r = uniq_rows[k];
                long long j = fnv1a(buf + starts[r], lens[r]) & (cap - 1);
                while (table[j] >= 0) j = (j + 1) & (cap - 1);
                table[j] = k;
            }
        }
        const char* p = buf + starts[i];
        int len = lens[i];
        long long j = fnv1a(p, len) & (cap - 1);
        for (;;) {
            long long e = table[j];
            if (e < 0) {
                if (card >= max_card) return -1;
                uniq_rows[card] = i;
                table[j] = card;
                codes[i] = (int)card;
                ++card;
                break;
            }
            long long r = uniq_rows[e];
            if (lens[r] == len && memcmp(buf + starts[r], p, len) == 0) {
                codes[i] = (int)e;
                break;
            }
            j = (j + 1) & (cap - 1);
        }
    }
    return card;
}

// ---- nogil encode plane ---------------------------------------------
//
// These entry points move the last GIL-held numpy glue of
// ingest/chunk.py (S-array gathers, NA membership, per-column
// reductions, the enum sort/remap) into released-GIL native passes so
// N parse workers scale to N cores — the chunk worker keeps only
// bookkeeping.

// Fixed-width token gather: out[i*width .. ] = the cell's bytes,
// zero-padded (the numpy S-array layout _tokens_sarr built through a
// slab of fancy-index passes). One memcpy per cell, no index matrix.
void csv_gather_tokens(const char* buf, const long long* starts,
                       const int* lens, long long n, long long width,
                       char* out) {
    memset(out, 0, (size_t)(n * width));
    for (long long i = 0; i < n; ++i) {
        int m = lens[i];
        if (m > 0) {
            if (m > width) m = (int)width;
            memcpy(out + i * width, buf + starts[i], (size_t)m);
        }
    }
}

// Membership flags: out[i] = 1 when cell i's bytes equal any of the
// n_pat patterns (concatenated in pat_buf at pat_offs/pat_lens) — the
// NA-string test np.isin ran over the gathered S array.
void csv_match_any(const char* buf, const long long* starts,
                   const int* lens, long long n,
                   const char* pat_buf, const long long* pat_offs,
                   const int* pat_lens, long long n_pat,
                   unsigned char* out) {
    for (long long i = 0; i < n; ++i) {
        unsigned char hit = 0;
        const char* p = buf + starts[i];
        int m = lens[i];
        for (long long k = 0; k < n_pat && !hit; ++k)
            if (pat_lens[k] == m
                    && memcmp(pat_buf + pat_offs[k], p, (size_t)m) == 0)
                hit = 1;
        out[i] = hit;
    }
}

// Numeric column detach + reductions in ONE pass: gather the selected
// columns' row slices [r0, r0+nrows) out of the column-major scratch
// arena (stride col_stride) into an owned [ncols_sel, nrows] block, and
// compute per column the finite |max| (fmax_out, -inf when no finite
// cell) and an all-finite flag — the isfinite/all/abs-max numpy passes
// that each re-walked the block under the GIL.
void csv_numeric_stats(const double* vals, long long col_stride,
                       const long long* col_idx, long long ncols_sel,
                       long long r0, long long nrows,
                       double* out_block, double* fmax_out,
                       unsigned char* allfin_out) {
    for (long long t = 0; t < ncols_sel; ++t) {
        const double* src = vals + col_idx[t] * col_stride + r0;
        double* dst = out_block + t * nrows;
        memcpy(dst, src, (size_t)nrows * sizeof(double));
        double fmax = -INFINITY;
        unsigned char allfin = 1;
        for (long long i = 0; i < nrows; ++i) {
            double v = dst[i];
            if (std::isfinite(v)) {
                double a = v < 0 ? -v : v;
                if (a > fmax) fmax = a;
            } else {
                allfin = 0;
            }
        }
        fmax_out[t] = fmax;
        allfin_out[t] = allfin;
    }
}

// Quote-aware row count: the SAME row-accounting as csv_parse (a row
// closes at an outside-quote newline when it saw any content; a
// content-bearing tail without a newline counts) with no per-cell
// work — the multi-host range planner's one cheap pass. Returns the
// row count, or -1 when a quote is left open (the caller cannot trust
// a count over a range it would decline).
long long csv_count_rows(const char* buf, long long len, char sep,
                         char quote) {
    long long r = 0, cidx = 0;
    bool any = false, at_start = true, in_row = false;
    long long i = 0;
    while (i < len) {
        char c = buf[i];
        if (c == quote && at_start) {
            ++i;
            for (;;) {
                if (i >= len) return -1;          // open quote
                if (buf[i] == quote) {
                    if (i + 1 < len && buf[i + 1] == quote) { i += 2; continue; }
                    ++i; break;
                }
                ++i;
            }
            any = true; at_start = false; in_row = true;
            continue;
        }
        if (c == '\n') {
            if (any || cidx > 0) ++r;
            cidx = 0; any = false; at_start = true; in_row = false;
        } else if (c == sep) {
            ++cidx; at_start = true; in_row = true;
        } else {
            if (c != '\r') { any = true; in_row = true; }
            at_start = false;
        }
        ++i;
    }
    if ((any || cidx > 0) && in_row) ++r;
    return r;
}

// Full enum encode: hash-dictionary build, ""-unescape, NA-string
// mapping, byte-lexicographic domain sort + dedupe, and the final
// code remap — ONE native pass chain replacing the per-label
// bytes.decode loop, sorted(set()), rank-LUT build and lut[codes] take
// that _codes_from_labels ran under the GIL. Outputs: codes[i] = rank
// of cell i's label in the SORTED deduped domain (NA cells = na_code);
// dom_rows[k] / dom_esc[k] = a representative cell row (+ its escape
// flag) for domain entry k, from which the caller decodes the label
// text (O(card), the only Python left). Returns the domain cardinality,
// -1 when it would exceed max_card (string fallback), or -2 when a
// label is not valid UTF-8 (byte order no longer matches Python's
// sorted(); caller takes the Python path).
long long csv_enum_encode_full(const char* buf, const long long* starts,
                               const int* lens, long long n,
                               const unsigned char* esc,
                               const char* na_buf, const long long* na_offs,
                               const int* na_lens, long long n_na,
                               long long max_card, int na_code,
                               int* codes, long long* dom_rows,
                               unsigned char* dom_esc) {
    // phase 1: raw-byte dictionary (first-appearance ids), same
    // open-addressing scheme as csv_enum_encode. Raw cardinality is
    // allowed a small overhead above max_card: NA labels and ""-escape
    // aliases collapse before the final count.
    const long long raw_cap_card = max_card + n_na + 1;
    std::vector<long long> uniq;                 // first row per raw id
    uniq.reserve(raw_cap_card < 4096 ? raw_cap_card : 4096);
    long long cap = 1024;
    std::vector<long long> table(cap, -1);
    for (long long i = 0; i < n; ++i) {
        long long card = (long long)uniq.size();
        if (card * 10 >= cap * 7) {
            cap <<= 1;
            table.assign(cap, -1);
            for (long long k = 0; k < card; ++k) {
                long long r = uniq[k];
                long long j = fnv1a(buf + starts[r], lens[r]) & (cap - 1);
                while (table[j] >= 0) j = (j + 1) & (cap - 1);
                table[j] = k;
            }
        }
        const char* p = buf + starts[i];
        int len = lens[i];
        long long j = fnv1a(p, len) & (cap - 1);
        for (;;) {
            long long e = table[j];
            if (e < 0) {
                if (card >= raw_cap_card) return -1;
                uniq.push_back(i);
                table[j] = card;
                codes[i] = (int)card;
                break;
            }
            long long r = uniq[e];
            if (lens[r] == len && memcmp(buf + starts[r], p, len) == 0) {
                codes[i] = (int)e;
                break;
            }
            j = (j + 1) & (cap - 1);
        }
    }
    const long long raw_card = (long long)uniq.size();
    // phase 2: per-unique label view — unescaped into a side arena when
    // the representative cell carries "" escapes — then UTF-8 validate.
    std::vector<char> arena;
    std::vector<long long> l_off(raw_card), l_len(raw_card);
    std::vector<unsigned char> l_in_arena(raw_card, 0);
    for (long long k = 0; k < raw_card; ++k) {
        long long r = uniq[k];
        const char* p = buf + starts[r];
        int m = lens[r];
        if (esc && esc[r] && m >= 2) {
            long long o = (long long)arena.size();
            for (int t = 0; t < m; ++t) {
                arena.push_back(p[t]);
                if (p[t] == '"' && t + 1 < m && p[t + 1] == '"') ++t;
            }
            l_off[k] = o;
            l_len[k] = (long long)arena.size() - o;
            l_in_arena[k] = 1;
        } else {
            l_off[k] = starts[r];
            l_len[k] = m;
        }
    }
    auto label = [&](long long k) -> const char* {
        return (l_in_arena[k] ? arena.data() + l_off[k] : buf + l_off[k]);
    };
    for (long long k = 0; k < raw_card; ++k)
        if (!valid_utf8((const unsigned char*)label(k), l_len[k]))
            return -2;
    // phase 3: NA membership on the unescaped label bytes (the decoded
    // string equality test `lab in nas`, moved to bytes — exact for
    // valid UTF-8 since the NA strings arrive UTF-8 encoded).
    std::vector<unsigned char> is_na(raw_card, 0);
    for (long long k = 0; k < raw_card; ++k) {
        const char* p = label(k);
        long long m = l_len[k];
        for (long long t = 0; t < n_na; ++t)
            if (na_lens[t] == m
                    && memcmp(na_buf + na_offs[t], p, (size_t)m) == 0) {
                is_na[k] = 1;
                break;
            }
    }
    // phase 4: byte-lexicographic sort of the non-NA raw ids (== code
    // point order == Python sorted() on the decoded labels), deduping
    // escape aliases that unescaped to the same bytes.
    std::vector<long long> order;
    order.reserve(raw_card);
    for (long long k = 0; k < raw_card; ++k)
        if (!is_na[k]) order.push_back(k);
    std::sort(order.begin(), order.end(),
              [&](long long a, long long b) {
                  long long la = l_len[a], lb = l_len[b];
                  int c = memcmp(label(a), label(b),
                                 (size_t)(la < lb ? la : lb));
                  if (c != 0) return c < 0;
                  return la < lb;
              });
    std::vector<int> lut(raw_card, na_code);
    long long dom = 0;
    for (size_t t = 0; t < order.size(); ++t) {
        long long k = order[t];
        if (t > 0) {
            long long pk = order[t - 1];
            if (l_len[pk] == l_len[k]
                    && memcmp(label(pk), label(k), (size_t)l_len[k]) == 0) {
                lut[k] = lut[pk];                // escape alias: same label
                continue;
            }
        }
        if (dom >= max_card) return -1;
        dom_rows[dom] = uniq[k];
        dom_esc[dom] = (esc && esc[uniq[k]]) ? 1 : 0;
        lut[k] = (int)dom;
        ++dom;
    }
    // phase 5: final remap — one pass, no Python.
    for (long long i = 0; i < n; ++i) codes[i] = lut[codes[i]];
    return dom;
}

}  // extern "C"
