// ALAC hot loops in C++ (host-side, ctypes):
//   * adaptive-Golomb residual decode (the 'dyn' code family;
//     behavioural parity: thirdparty/apple_alac/codec/ag_dec.c)
//   * sign-adaptive FIR prediction synthesis
//     (thirdparty/apple_alac/codec/dp_dec.c)
// These mirror the pure-Python implementations in codecs/alac.py
// (dyn_decomp / unpc_block), which remain the documented fallback.

#include <cstdint>
#include <cstring>

namespace {

constexpr int QBSHIFT = 9;
constexpr int32_t QB = 1 << QBSHIFT;
constexpr int MMULSHIFT = 2;
constexpr int MDENSHIFT = QBSHIFT - MMULSHIFT - 1;
constexpr int32_t MOFF = 1 << (MDENSHIFT - 2);
constexpr int BITOFF = 24;
constexpr int MAX_PREFIX = 9;
constexpr int MAX_DATATYPE_BITS_16 = 16;

struct Bits {
    const uint8_t* data;
    int64_t nbytes;   // padded length
    int64_t pos;      // bit position
};

inline uint32_t bits_read(Bits& b, int n) {
    if (n == 0) return 0;
    int64_t p = b.pos;
    int64_t first = p >> 3;
    uint64_t chunk = 0;
    for (int i = 0; i < 8 && first + i < b.nbytes; i++)
        chunk = (chunk << 8) | b.data[first + i];
    int avail = (int)((b.nbytes - first) < 8 ? (b.nbytes - first) : 8) * 8;
    chunk >>= avail - ((p & 7) + n);
    b.pos = p + n;
    return (uint32_t)(chunk & ((n == 32) ? 0xFFFFFFFFu
                               : ((1u << n) - 1)));
}

inline uint32_t peek32(const Bits& b) {
    int64_t p = b.pos;
    int64_t first = p >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5; i++)
        v = (v << 8) | (first + i < b.nbytes ? b.data[first + i] : 0);
    return (uint32_t)((v >> (8 - (p & 7))) & 0xFFFFFFFFu);
}

inline int lead_zeros32(uint32_t x) {
    return x == 0 ? 32 : __builtin_clz(x);
}

inline int lg3a(uint32_t x) { return 31 - lead_zeros32(x + 3); }

inline uint32_t dyn_get_32(Bits& b, uint32_t m, int k, int maxbits) {
    uint32_t stream = peek32(b);
    int pre = lead_zeros32(~stream);
    if (pre >= MAX_PREFIX) {
        b.pos += MAX_PREFIX;
        return bits_read(b, maxbits);
    }
    b.pos += pre + 1;
    if (k == 1) return (uint32_t)pre;
    uint32_t v = peek32(b) >> (32 - k);
    b.pos += k - 1;
    uint32_t result = (uint32_t)pre * m;
    if (v >= 2) {
        result += v - 1;
        b.pos += 1;
    }
    return result;
}

inline uint32_t dyn_get_16(Bits& b, uint32_t m, int k) {
    uint32_t stream = peek32(b);
    int pre = lead_zeros32(~stream);
    if (pre >= MAX_PREFIX) {
        b.pos += MAX_PREFIX;
        return bits_read(b, MAX_DATATYPE_BITS_16);
    }
    b.pos += pre + 1;
    uint32_t v = peek32(b) >> (32 - k);
    b.pos += k;
    uint32_t result = (uint32_t)pre * m + v - 1;
    if (v < 2) {
        result -= (v - 1);
        b.pos -= 1;
    }
    return result;
}

}  // namespace

extern "C" {

// Returns 0 ok, -1 zero-run overrun.  bit_pos is in/out.
int alac_dyn_decomp(const uint8_t* data, int64_t nbytes, int64_t* bit_pos,
                    int num, int chan_bits, int32_t mb0, int32_t pb,
                    int kb, int32_t* out) {
    Bits b{data, nbytes, *bit_pos};
    memset(out, 0, sizeof(int32_t) * num);
    int32_t mb = mb0;
    uint32_t wb = (1u << kb) - 1;
    int zmode = 0;
    int c = 0;
    while (c < num) {
        uint32_t m = (uint32_t)(mb >> QBSHIFT);
        int k = lg3a(m);
        if (k > kb) k = kb;
        m = (1u << k) - 1;
        uint32_t n = dyn_get_32(b, m, k, chan_bits);
        uint32_t ndecode = n + (uint32_t)zmode;
        int32_t mult = -((int32_t)(ndecode & 1)) | 1;
        out[c] = (int32_t)((ndecode + 1) >> 1) * mult;
        c += 1;
        mb = (int32_t)(pb * (int64_t)(n + (uint32_t)zmode) + mb
                       - (((int64_t)pb * mb) >> QBSHIFT));
        if (n > 0xFFFF) mb = 0xFFFF;
        zmode = 0;
        if (((int64_t)mb << MMULSHIFT) < QB && c < num) {
            zmode = 1;
            int kk = lead_zeros32((uint32_t)mb) - BITOFF
                + ((mb + MOFF) >> MDENSHIFT);
            uint32_t mz = ((1u << kk) - 1) & wb;
            uint32_t nz = dyn_get_16(b, mz, kk);
            if (c + (int64_t)nz > num) return -1;
            c += (int)nz;            // out already zero
            if (nz >= 0xFFFF) zmode = 0;
            mb = 0;
        }
    }
    *bit_pos = b.pos;
    return 0;
}

// Sign-adaptive FIR prediction synthesis; coefs (int32[32]) mutate like
// the reference's adaptive filter.  Returns 0.
int alac_unpc_block(const int32_t* resid, int num, int32_t* coefs,
                    int numactive, int chan_bits, int denshift,
                    int32_t* out) {
    const int64_t shift_mod = 1ll << chan_bits;
    const int64_t half = shift_mod >> 1;
    auto wrap = [&](int64_t v) -> int64_t {
        int64_t r = (v + half) % shift_mod;
        if (r < 0) r += shift_mod;
        return r - half;
    };
    out[0] = resid[0];
    if (numactive == 0) {
        memcpy(out + 1, resid + 1, sizeof(int32_t) * (num - 1));
        return 0;
    }
    if (numactive == 31) {
        int64_t prev = out[0];
        for (int j = 1; j < num; j++) {
            prev = wrap((int64_t)resid[j] + prev);
            out[j] = (int32_t)prev;
        }
        return 0;
    }
    for (int j = 1; j <= numactive && j < num; j++)
        out[j] = (int32_t)wrap((int64_t)resid[j] + out[j - 1]);
    int lim = numactive + 1;
    int64_t co[32];
    for (int k = 0; k < numactive; k++) co[k] = coefs[k];
    const int64_t denhalf = 1ll << (denshift - 1);
    for (int j = lim; j < num; j++) {
        int64_t top = out[j - lim];
        int base = j - 1;
        int64_t sum1 = 0;
        for (int k = 0; k < numactive; k++)
            sum1 += co[k] * ((int64_t)out[base - k] - top);
        int64_t del = resid[j];
        int64_t del0 = del;
        int sg = (del > 0) - (del < 0);
        del += top + ((sum1 + denhalf) >> denshift);
        out[j] = (int32_t)wrap(del);
        if (sg > 0) {
            for (int k = numactive - 1; k >= 0; k--) {
                int64_t dd = top - out[base - k];
                int sgn = (dd > 0) - (dd < 0);
                co[k] -= sgn;
                del0 -= (int64_t)(numactive - k) * ((sgn * dd) >> denshift);
                if (del0 <= 0) break;
            }
        } else if (sg < 0) {
            for (int k = numactive - 1; k >= 0; k--) {
                int64_t dd = top - out[base - k];
                int sgn = (dd > 0) - (dd < 0);
                co[k] += sgn;
                del0 -= (int64_t)(numactive - k) * ((-sgn * dd) >> denshift);
                if (del0 >= 0) break;
            }
        }
    }
    for (int k = 0; k < numactive; k++) coefs[k] = (int32_t)co[k];
    return 0;
}

}  // extern "C"
