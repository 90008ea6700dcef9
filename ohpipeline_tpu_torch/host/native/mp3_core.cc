// MP3 Layer III Huffman spectrum decode in C++ (host-side, ctypes).
// Behavioural parity: the pure-Python parse_huffman in
// codecs/mp3/bitstream.py (itself validated sample-exact vs libmad,
// thirdparty/libmad-0.15.1b/layer3.c III_huffdecode), which remains the
// fallback.  LUTs are the same flattened prefix tables the Python
// HuffLut builds (registered once per process like the AAC tables).

#include <cstdint>
#include <cstring>

namespace {

struct Lut {
    int maxlen = 0;
    const uint8_t* lengths = nullptr;   // [1 << maxlen]
    const int32_t* rows = nullptr;      // [1 << maxlen]
    const int8_t* vals = nullptr;       // [nrows * dim]
    int dim = 0;
    int linbits = 0;
    // packed = (row << 6) | len (0 = invalid): one load per codeword;
    // tables longer than 12 bits (up to 2 MB flat) get an L1-resident
    // 10-bit first level covering the short high-probability codes
    uint32_t* packed = nullptr;
    uint32_t* fast = nullptr;
};
constexpr int MP3_FAST = 10;

inline void build_packed(Lut& l) {
    size_t n = (size_t)1 << l.maxlen;
    delete[] l.packed;
    l.packed = new uint32_t[n];
    for (size_t w = 0; w < n; w++)
        l.packed[w] = l.lengths[w]
            ? (((uint32_t)l.rows[w]) << 6) | l.lengths[w] : 0;
    delete[] l.fast;
    l.fast = nullptr;
    if (l.maxlen > 12) {
        l.fast = new uint32_t[(size_t)1 << MP3_FAST];
        for (size_t w = 0; w < ((size_t)1 << MP3_FAST); w++) {
            uint32_t e = l.packed[w << (l.maxlen - MP3_FAST)];
            l.fast[w] = (e && (e & 63) <= MP3_FAST) ? e : 0;
        }
    }
}

inline uint32_t lut_lookup(const Lut& l, uint32_t w) {
    if (l.fast) {
        uint32_t e = l.fast[w >> (l.maxlen - MP3_FAST)];
        if (e) return e;
    }
    return l.packed[w];
}

Lut g_pair[32];     // table id 0..31 (0 unused)
Lut g_quad[2];

struct Bits {
    const uint8_t* data;
    int64_t nbits;
    int64_t pos;
};

inline uint32_t peek(const Bits& b, int n) {
    int64_t first = b.pos >> 3;
    if ((first + 8) * 8 <= b.nbits) {
        // fast path: one unaligned 64-bit load (the wrapper passes
        // len(data)*8 as nbits, so all 8 bytes are in the buffer)
        uint64_t w;
        memcpy(&w, b.data + first, 8);
        w = __builtin_bswap64(w) << (b.pos & 7);
        return (uint32_t)(w >> (64 - n));
    }
    // zero-padded tail (HuffLut peeks near stream end)
    uint64_t v = 0;
    for (int i = 0; i < 6; i++) {
        int64_t idx = first + i;
        v = (v << 8) | (idx * 8 < b.nbits ? b.data[idx] : 0);
    }
    int shift = 48 - (int)(b.pos & 7) - n;
    return (uint32_t)((v >> shift) & ((1u << n) - 1));
}

inline int read_bits(Bits& b, int n, uint32_t* out) {
    if (b.pos + n > b.nbits) return -1;
    *out = peek(b, n);
    b.pos += n;
    return 0;
}

}  // namespace

extern "C" {

void mp3_set_pair_table(int tid, int maxlen, const uint8_t* lengths,
                        const int32_t* rows, const int8_t* vals,
                        int linbits) {
    if (tid < 0 || tid >= 32) return;
    Lut& l = g_pair[tid];
    uint32_t* op = l.packed;
    uint32_t* of = l.fast;
    l = {maxlen, lengths, rows, vals, 2, linbits, op, of};
    build_packed(l);
}

void mp3_set_quad_table(int which, int maxlen, const uint8_t* lengths,
                        const int32_t* rows, const int8_t* vals) {
    if (which < 0 || which >= 2) return;
    Lut& l = g_quad[which];
    uint32_t* op = l.packed;
    uint32_t* of = l.fast;
    l = {maxlen, lengths, rows, vals, 4, 0, op, of};
    build_packed(l);
}

// Decode big_values pairs + count1 quads into out[576].
// Returns 0 ok, -1 bitstream exhausted mid-field (mirrors EOFError).
// *bit_pos is set to end_bit on success (the Python path does the
// same); overread inside the last quad zeroes it, like libmad.
int mp3_parse_huffman(const uint8_t* data, int64_t nbits,
                      int64_t* bit_pos, int64_t end_bit, int big,
                      int region1, int region2, int t0, int t1, int t2,
                      int count1table, int32_t* out) {
    Bits b{data, nbits, *bit_pos};
    memset(out, 0, sizeof(int32_t) * 576);
    int i = 0;
    while (i < big) {
        int tid = i < region1 ? t0 : (i < region2 ? t1 : t2);
        const Lut& lut = g_pair[tid >= 0 && tid < 32 ? tid : 0];
        if (lut.lengths == nullptr) {   // table 0: all zeros
            i += 2;
            continue;
        }
        if (b.pos >= end_bit) break;
        uint32_t w = peek(b, lut.maxlen);
        uint32_t e = lut_lookup(lut, w);
        if (e == 0) return -2;          // invalid code (ValueError)
        b.pos += e & 63;                // skip may pass the end, like
                                        // BitReader.skip; reads error
        const int8_t* xy = &lut.vals[(e >> 6) * 2];
        int32_t x = xy[0], y = xy[1];
        uint32_t bit;
        if (x == 15 && lut.linbits) {
            if (read_bits(b, lut.linbits, &bit)) return -1;
            x += (int32_t)bit;
        }
        if (x) {
            if (read_bits(b, 1, &bit)) return -1;
            if (bit) x = -x;
        }
        if (y == 15 && lut.linbits) {
            if (read_bits(b, lut.linbits, &bit)) return -1;
            y += (int32_t)bit;
        }
        if (y) {
            if (read_bits(b, 1, &bit)) return -1;
            if (bit) y = -y;
        }
        out[i] = x;
        out[i + 1] = y;
        i += 2;
    }
    const Lut& q = g_quad[count1table ? 1 : 0];
    while (b.pos < end_bit && i <= 572) {
        uint32_t w = peek(b, q.maxlen);
        uint32_t e = lut_lookup(q, w);
        if (e == 0) return -2;
        b.pos += e & 63;
        const int8_t* v4 = &q.vals[(e >> 6) * 4];
        for (int j = 0; j < 4; j++) {
            int32_t v = v4[j];
            if (v) {
                uint32_t bit;
                if (read_bits(b, 1, &bit)) return -1;
                if (bit) v = -v;
            }
            if (i < 576) out[i] = v;
            i++;
        }
    }
    if (b.pos > end_bit) {
        int lo = i - 4 > 0 ? i - 4 : 0;
        for (int j = lo; j < i && j < 576; j++) out[j] = 0;
    }
    *bit_pos = end_bit;
    return 0;
}

}  // extern "C"
