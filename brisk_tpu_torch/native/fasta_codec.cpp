// Native host-side FASTA parser + 2-bit encoder.
//
// Host I/O must not hold back the device pipeline, so the FASTA bytes
// become 2-bit codes here, in ranges of the file that run on threads of
// their own (native/__init__.py cuts the file and stitches the ranges).
//
// Semantics mirror the reference's getLineFasta/clean_dna
// (apps/counter.cpp:130-190): records are the concatenated sequence lines
// between '>' headers ('>' starts a header only at a line's start); each
// record is split into chunks at every non-ACGT character
// (case-insensitive); chunks are emitted as 2-bit codes ((c>>1)&3,
// Kmers.cpp:442-444). '\r' is skipped like '\n' but does not start a line.
//
// C ABI (ctypes). The caller reads the bytes (a range of a file, or a
// stream it decompresses) and owns the codes: a parse writes them into the
// caller's buffer and keeps only its state and its splits, the code
// counts at which a chunk must end (a header or a non-ACGT character),
// each recorded once.
//   brisk_fasta_new / brisk_fasta_free    a parse's state, at a line start
//   brisk_fasta_feed                      one block of bytes; codes at
//                                         out[n..), n the count so far
//   brisk_fasta_n_splits / _splits        the splits, increasing
// A range that starts at a line start parses exactly as the same bytes do
// inside one pass over the whole file, with the chunk that crosses its
// start continued: so cutting a file at line starts and concatenating the
// ranges' codes and splits gives the one pass's chunks.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// A byte's class: its code 0-3 (ACGT, either case), or one of these.
constexpr uint8_t kEol = 4;    // '\n': ends the line
constexpr uint8_t kSkip = 5;   // '\r'
constexpr uint8_t kSplit = 6;  // anything else: ends the chunk

struct Classes {
    uint8_t c[256];
    Classes() {
        memset(c, kSplit, sizeof c);
        for (const char* p = "ACGTacgt"; *p; p++)
            c[(uint8_t)*p] = ((uint8_t)*p >> 1) & 3;
        c[(uint8_t)'\n'] = kEol;
        c[(uint8_t)'\r'] = kSkip;
    }
};
const Classes kClass;

struct Parse {
    uint64_t n = 0;              // codes written
    uint64_t last = UINT64_MAX;  // n at the last recorded split
    bool in_header = false;
    bool line_start = true;
    std::vector<uint64_t> splits;

    void split() {
        if (n != last) {
            splits.push_back(n);
            last = n;
        }
    }

    // Parse [p, e), writing codes at out[n..).
    void feed(const uint8_t* p, const uint8_t* e, uint8_t* out) {
        const uint8_t* cls = kClass.c;
        while (p < e) {
            if (line_start) {
                line_start = false;
                if (*p == '>') {
                    split();
                    in_header = true;
                }
            }
            if (in_header) {
                auto* nl = (const uint8_t*)memchr(p, '\n', e - p);
                if (!nl) return;  // the header goes on in the next block
                p = nl + 1;
                in_header = false;
                line_start = true;
                continue;
            }
            uint64_t k = n;
            while (p < e) {
                // eight bases at a time while none is special
                while (e - p >= 8) {
                    uint8_t c[8], any = 0;
                    for (int i = 0; i < 8; i++) {
                        c[i] = cls[p[i]];
                        any |= c[i];
                    }
                    if (any > 3) break;
                    memcpy(out + k, c, 8);
                    k += 8;
                    p += 8;
                }
                if (p == e) break;
                uint8_t c = cls[*p++];
                if (c <= 3) {
                    out[k++] = c;
                } else if (c == kEol) {
                    line_start = true;
                    break;
                } else if (c == kSplit) {
                    n = k;
                    split();
                }
            }
            n = k;
        }
    }
};

}  // namespace

extern "C" {

void* brisk_fasta_new() { return new Parse(); }

void brisk_fasta_free(void* h) { delete (Parse*)h; }

// Parse one block of bytes, writing its codes at out[n..) (room for
// n + len codes); returns the new n.
uint64_t brisk_fasta_feed(void* h, const uint8_t* in, uint64_t len,
                          uint8_t* out) {
    auto* r = (Parse*)h;
    r->feed(in, in + len, out);
    return r->n;
}

uint64_t brisk_fasta_n_splits(void* h) { return ((Parse*)h)->splits.size(); }

const uint64_t* brisk_fasta_splits(void* h) {
    return ((Parse*)h)->splits.data();
}

}  // extern "C"
