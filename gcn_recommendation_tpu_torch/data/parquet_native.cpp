// The byte loops of the parquet reader (data/parquet.py): SNAPPY
// decompression and the RLE / bit-packed hybrid decoding of definition
// levels and dictionary indices.
//
// Parquet files written by pyarrow compress every page with SNAPPY by
// default.  The format is a varint of the uncompressed length followed by
// a stream of elements, each a literal run or a copy of earlier output;
// copies make the decoder a sequential byte loop.  The hybrid encoding is
// a stream of runs (a repeated value, or groups of 8 bit-packed values),
// one run per distinct user on a sorted column: hundreds of thousands of
// runs on a large file.  Both run here in C++ instead of Python.  Built
// with g++ by data/native_ext.py's build_library and bound with ctypes;
// there is no Python fallback.
//
// Both decoders return a count (bytes written / bytes read) on success,
// else one of the negative codes below.  Every read and write is
// bounds-checked: a damaged page gives an error code, never a guess.

#include <cstdint>
#include <algorithm>
#include <cstring>

namespace {

constexpr int64_t kTruncated = -1;      // the stream ends inside an element
constexpr int64_t kBadOffset = -2;      // a copy reaches before the output's start
constexpr int64_t kOverflow = -3;       // more output than the preamble declared
constexpr int64_t kShort = -4;          // less output than the preamble declared
constexpr int64_t kBadPreamble = -5;    // the length varint is malformed
constexpr int64_t kBadWidth = -6;       // a bit width outside [0, 32]

}  // namespace

extern "C" {

// The uncompressed length from the preamble of ``src``; negative on error.
int64_t pq_snappy_length(const uint8_t* src, int64_t n) {
    uint64_t v = 0;
    for (int64_t i = 0, shift = 0; i < n && shift <= 35; ++i, shift += 7) {
        v |= uint64_t(src[i] & 0x7f) << shift;
        if (!(src[i] & 0x80)) return int64_t(v);
    }
    return kBadPreamble;
}

int64_t pq_snappy_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t dst_cap) {
    int64_t ip = 0;
    uint64_t expect = 0;
    for (int shift = 0;; shift += 7) {
        if (ip >= n || shift > 35) return kBadPreamble;
        uint8_t b = src[ip++];
        expect |= uint64_t(b & 0x7f) << shift;
        if (!(b & 0x80)) break;
    }
    if (int64_t(expect) > dst_cap) return kOverflow;
    int64_t op = 0;
    const int64_t out_end = int64_t(expect);
    while (ip < n) {
        const uint8_t tag = src[ip++];
        const int kind = tag & 3;
        if (kind == 0) {  // literal
            int64_t len = tag >> 2;
            if (len >= 60) {
                const int extra = int(len) - 59;  // 1..4 length bytes
                if (ip + extra > n) return kTruncated;
                len = 0;
                for (int k = 0; k < extra; ++k) len |= int64_t(src[ip + k]) << (8 * k);
                ip += extra;
            }
            len += 1;
            if (ip + len > n) return kTruncated;
            if (op + len > out_end) return kOverflow;
            std::memcpy(dst + op, src + ip, size_t(len));
            ip += len;
            op += len;
            continue;
        }
        int64_t len, offset;
        if (kind == 1) {
            if (ip + 1 > n) return kTruncated;
            len = 4 + ((tag >> 2) & 7);
            offset = (int64_t(tag >> 5) << 8) | src[ip];
            ip += 1;
        } else if (kind == 2) {
            if (ip + 2 > n) return kTruncated;
            len = (tag >> 2) + 1;
            offset = int64_t(src[ip]) | (int64_t(src[ip + 1]) << 8);
            ip += 2;
        } else {
            if (ip + 4 > n) return kTruncated;
            len = (tag >> 2) + 1;
            offset = int64_t(src[ip]) | (int64_t(src[ip + 1]) << 8) |
                     (int64_t(src[ip + 2]) << 16) | (int64_t(src[ip + 3]) << 24);
            ip += 4;
        }
        if (offset <= 0 || offset > op) return kBadOffset;
        if (op + len > out_end) return kOverflow;
        uint8_t* d = dst + op;
        const uint8_t* s = d - offset;
        if (offset >= len) {
            std::memcpy(d, s, size_t(len));
        } else {
            for (int64_t k = 0; k < len; ++k) d[k] = s[k];  // overlapping: a repeat
        }
        op += len;
    }
    return op == out_end ? op : kShort;
}

// ``count`` values of the RLE / bit-packed hybrid encoding at ``src``
// (at most ``n`` bytes, values ``bit_width`` bits wide) into ``out``;
// returns the bytes read.  A run longer than what is left is cut at
// ``count``, as the format allows for the last run of a page.
int64_t pq_decode_hybrid(const uint8_t* src, int64_t n, int bit_width, int64_t count,
                         uint32_t* out) {
    if (bit_width < 0 || bit_width > 32) return kBadWidth;
    const int vbytes = (bit_width + 7) / 8;
    const uint64_t mask = bit_width == 32 ? 0xffffffffull : ((1ull << bit_width) - 1);
    int64_t ip = 0, filled = 0;
    while (filled < count) {
        uint64_t header = 0;
        for (int shift = 0;; shift += 7) {
            if (ip >= n || shift > 63) return kTruncated;
            const uint8_t b = src[ip++];
            header |= uint64_t(b & 0x7f) << shift;
            if (!(b & 0x80)) break;
        }
        if (header & 1) {  // bit-packed: (header >> 1) groups of 8 values
            const uint64_t groups = header >> 1;
            if (groups > uint64_t(n)) return kTruncated;
            const int64_t nbytes = int64_t(groups) * bit_width;
            if (ip + nbytes > n) return kTruncated;
            const int64_t take = std::min<int64_t>(int64_t(groups) * 8, count - filled);
            const uint8_t* p = src + ip;
            for (int64_t k = 0; k < take; ++k) {
                const int64_t bit = k * bit_width;
                uint64_t v = 0;
                const int64_t first = bit >> 3;
                const int nb = int((((bit & 7) + bit_width) + 7) >> 3);
                for (int j = 0; j < nb; ++j) v |= uint64_t(p[first + j]) << (8 * j);
                out[filled + k] = uint32_t((v >> (bit & 7)) & mask);
            }
            ip += nbytes;
            filled += take;
        } else {  // RLE: one value repeated (header >> 1) times
            const uint64_t len = header >> 1;
            if (ip + vbytes > n) return kTruncated;
            uint32_t v = 0;
            for (int j = 0; j < vbytes; ++j) v |= uint32_t(src[ip + j]) << (8 * j);
            ip += vbytes;
            const int64_t take = std::min<int64_t>(int64_t(std::min<uint64_t>(len, uint64_t(count))),
                                                   count - filled);
            for (int64_t k = 0; k < take; ++k) out[filled + k] = v;
            filled += take;
        }
    }
    return ip;
}

}  // extern "C"
