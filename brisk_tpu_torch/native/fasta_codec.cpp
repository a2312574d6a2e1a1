// Native host-side FASTA parser + 2-bit encoder.
//
// The one legitimately-native piece of the TPU engine (SURVEY §7 hard part
// 6): host I/O must not bottleneck the device pipeline, and the 2-vCPU
// host cannot parse FASTA line-by-line in Python at device rates.
//
// Semantics mirror the reference's getLineFasta/clean_dna
// (apps/counter.cpp:130-190): records are the concatenated sequence lines
// between '>' headers; each record is split into chunks at runs of
// non-ACGT characters (case-insensitive); chunks are emitted as 2-bit
// codes ((c>>1)&3 — case-insensitive by construction, Kmers.cpp:442-444).
//
// C ABI (ctypes): parse into one flat code buffer + chunk offsets.
// Transparent gzip via zlib.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

struct ParseResult {
    std::vector<uint8_t> codes;     // 2-bit code per base, all chunks
    std::vector<uint64_t> offsets;  // chunk start offsets; size = n+1
};

const int8_t kCode[256] = {
    // -1 everywhere except ACGTacgt which map to (c>>1)&3
#define X -1
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, 0, X, 1, X, X, X, 3, X, X, X, X, X, X, X, X,   // A C G
    X, X, X, X, 2, X, X, X, X, X, X, X, X, X, X, X,   // T
    X, 0, X, 1, X, X, X, 3, X, X, X, X, X, X, X, X,   // a c g
    X, X, X, X, 2, X, X, X, X, X, X, X, X, X, X, X,   // t
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
#undef X
};

void finish_chunk(ParseResult* r, bool* in_chunk) {
    if (*in_chunk) {
        r->offsets.push_back(r->codes.size());
        *in_chunk = false;
    }
}

}  // namespace

extern "C" {

// Parse a (possibly gzipped) FASTA file. Returns an opaque handle, or
// nullptr on failure. Chunk i spans codes[offsets[i] .. offsets[i+1]).
void* brisk_fasta_parse(const char* path) {
    gzFile f = gzopen(path, "rb");
    if (!f) return nullptr;
    gzbuffer(f, 1 << 20);

    auto* r = new ParseResult();
    r->offsets.push_back(0);
    r->codes.reserve(1 << 20);

    std::vector<char> buf(1 << 20);
    bool in_header = false;
    bool in_chunk = false;   // currently accumulating a valid-base run
    bool at_line_start = true;
    int n;
    while ((n = gzread(f, buf.data(), buf.size())) > 0) {
        for (int i = 0; i < n; i++) {
            char c = buf[i];
            bool line_start = at_line_start;
            at_line_start = (c == '\n');
            if (in_header) {
                if (c == '\n') in_header = false;
                continue;
            }
            if (c == '>' && line_start) {
                // record boundary: close the current chunk ('>' only
                // starts a header at line start, like getLineFasta)
                finish_chunk(r, &in_chunk);
                in_header = true;
                continue;
            }
            if (c == '\n' || c == '\r') continue;
            int8_t code = kCode[(uint8_t)c];
            if (code < 0) {
                // invalid base: split here (clean_dna semantics)
                finish_chunk(r, &in_chunk);
            } else {
                r->codes.push_back((uint8_t)code);
                in_chunk = true;
            }
        }
    }
    finish_chunk(r, &in_chunk);
    gzclose(f);
    if (n < 0) {
        delete r;
        return nullptr;
    }
    return r;
}

uint64_t brisk_fasta_n_chunks(void* handle) {
    return ((ParseResult*)handle)->offsets.size() - 1;
}

uint64_t brisk_fasta_n_codes(void* handle) {
    return ((ParseResult*)handle)->codes.size();
}

const uint8_t* brisk_fasta_codes(void* handle) {
    return ((ParseResult*)handle)->codes.data();
}

const uint64_t* brisk_fasta_offsets(void* handle) {
    return ((ParseResult*)handle)->offsets.data();
}

void brisk_fasta_free(void* handle) {
    delete (ParseResult*)handle;
}

}  // extern "C"
