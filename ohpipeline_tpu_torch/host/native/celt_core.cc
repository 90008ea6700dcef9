// CELT entropy-layer decode core (hot loop of codecs/opus/celt.py).
//
// Port of the Python reference path in this repo -- range decoder
// (range_dec.py), coarse/fine energy, tf_decode, dynalloc, allocation
// (alloc.py), PVQ band decode (celt.py _quant_* / pvq.py) and
// anti-collapse -- everything between RangeDecoder init and MDCT
// synthesis.  Behavioural parity target: opus-1.5.2 celt/entdec.c,
// rate.c, bands.c, cwrs.c, laplace.c decode side, as validated by the
// same oracle tests that cover the Python path
// (tests/test_opus_celt.py vs tools/celt_probe.c).
//
// The Python implementation stays as the documented fallback
// (OHP_CELT_PY=1); tests/test_native_celt.py pins agreement.  All
// integer/wire decisions here are bit-exact vs the Python path; float
// spectral math matches to ulps (numpy BLAS dot ordering and numpy's
// float32 exp2 differ from a plain loop/libm in the last ulp).
// Compile with -ffp-contract=off (native/__init__.py passes it) so no
// FMA contraction perturbs the float32 energy recursions.

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

constexpr int BITRES = 3;
constexpr int SPREAD_NONE = 0;
constexpr int SPREAD_AGGRESSIVE = 3;
constexpr int MAX_FINE_BITS = 8;
constexpr int FINE_OFFSET = 21;
constexpr int ALLOC_STEPS = 6;
constexpr int LOG_MAX_PSEUDO = 6;
constexpr int QTHETA_OFFSET = 4;
constexpr int QTHETA_OFFSET_TWOPHASE = 16;

const int TRIM_ICDF[11] = {126, 124, 119, 109, 87, 41, 19, 9, 4, 2, 0};
const int SPREAD_ICDF[4] = {25, 23, 2, 0};
const int TAPSET_ICDF[3] = {2, 1, 0};
const int SMALL_ENERGY_ICDF[3] = {2, 1, 0};
const int TF_SELECT_TABLE[4][8] = {
    {0, -1, 0, -1, 0, -1, 0, -1},
    {0, -1, 0, -2, 1, 0, 1, -1},
    {0, -2, 0, -3, 2, 0, 1, -1},
    {0, -2, 0, -3, 3, 0, 1, -1},
};
const int LOG2_FRAC[24] = {0, 8, 13, 16, 19, 21, 23, 24, 26, 27, 28, 29,
                           30, 31, 32, 32, 33, 34, 34, 35, 36, 36, 37, 37};
const double PRED_COEF[4] = {29440 / 32768., 26112 / 32768.,
                             21248 / 32768., 16384 / 32768.};
const double BETA_COEF[4] = {30147 / 32768., 22282 / 32768.,
                             12124 / 32768., 6554 / 32768.};
const double BETA_INTRA = 4915 / 32768.;

// e_prob_model[LM][intra][42] (celt.py E_PROB_MODEL)
const int E_PROB_MODEL[4][2][42] = {
    {{72, 127, 65, 129, 66, 128, 65, 128, 64, 128, 62, 128, 64, 128,
      64, 128, 92, 78, 92, 79, 92, 78, 90, 79, 116, 41, 115, 40,
      114, 40, 132, 26, 132, 26, 145, 17, 161, 12, 176, 10, 177, 11},
     {24, 179, 48, 138, 54, 135, 54, 132, 53, 134, 56, 133, 55, 132,
      55, 132, 61, 114, 70, 96, 74, 88, 75, 88, 87, 74, 89, 66,
      91, 67, 100, 59, 108, 50, 120, 40, 122, 37, 97, 43, 78, 50}},
    {{83, 78, 84, 81, 88, 75, 86, 74, 87, 71, 90, 73, 93, 74,
      93, 74, 109, 40, 114, 36, 117, 34, 117, 34, 143, 17, 145, 18,
      146, 19, 162, 12, 165, 10, 178, 7, 189, 6, 190, 8, 177, 9},
     {23, 178, 54, 115, 63, 102, 66, 98, 69, 99, 74, 89, 71, 91,
      73, 91, 78, 89, 86, 80, 92, 66, 93, 64, 102, 59, 103, 60,
      104, 60, 117, 52, 123, 44, 138, 35, 133, 31, 97, 38, 77, 45}},
    {{61, 90, 93, 60, 105, 42, 107, 41, 110, 45, 116, 38, 113, 38,
      112, 38, 124, 26, 132, 27, 136, 19, 140, 20, 155, 14, 159, 16,
      158, 18, 170, 13, 177, 10, 187, 8, 192, 6, 175, 9, 159, 10},
     {21, 178, 59, 110, 71, 86, 75, 85, 84, 83, 91, 66, 88, 73,
      87, 72, 92, 75, 98, 72, 105, 58, 107, 54, 115, 52, 114, 55,
      112, 56, 129, 51, 132, 40, 150, 33, 140, 29, 98, 35, 77, 42}},
    {{42, 121, 96, 66, 108, 43, 111, 40, 117, 44, 123, 32, 120, 36,
      119, 33, 127, 33, 134, 34, 139, 21, 147, 23, 152, 20, 158, 25,
      154, 26, 166, 21, 173, 16, 184, 13, 184, 10, 150, 13, 139, 15},
     {22, 178, 63, 114, 74, 82, 84, 83, 92, 82, 103, 62, 96, 72,
      96, 67, 101, 73, 107, 72, 113, 55, 118, 52, 125, 52, 118, 52,
      117, 55, 135, 49, 137, 39, 157, 32, 145, 29, 97, 33, 77, 40}},
};

inline int ec_ilog(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

inline int cdiv(int a, int b) {  // C-style trunc-toward-zero division
    int q = (a < 0 ? -a : a) / b;
    return a < 0 ? -q : q;
}

inline int64_t fdiv64(int64_t a, int64_t b) {  // Python // (floor)
    int64_t q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

inline uint32_t lcg(uint32_t seed) {
    return 1664525u * seed + 1013904223u;
}

// ---- range decoder (range_dec.py / entdec.c) --------------------------

constexpr int SYM_BITS = 8;
constexpr int CODE_BITS = 32;
constexpr uint32_t SYM_MAX = (1u << SYM_BITS) - 1;
constexpr uint32_t CODE_TOP = 1u << (CODE_BITS - 1);
constexpr uint32_t CODE_BOT = CODE_TOP >> SYM_BITS;
constexpr int CODE_EXTRA = (CODE_BITS - 2) % SYM_BITS + 1;
constexpr int UINT_BITS = 8;
constexpr uint32_t MASK31 = CODE_TOP - 1;

struct RD {
    const uint8_t* buf;
    int storage;
    int offs;
    int end_offs;
    uint64_t end_window;
    int nend_bits;
    int nbits_total;
    uint32_t rng;
    int rem;
    uint32_t val;
    int error;
    uint32_t ext;

    int read_byte() {
        if (offs < storage) return buf[offs++];
        return 0;
    }
    int read_byte_from_end() {
        if (end_offs < storage) {
            end_offs += 1;
            return buf[storage - end_offs];
        }
        return 0;
    }
    void normalize() {
        while (rng <= CODE_BOT) {
            nbits_total += SYM_BITS;
            rng <<= SYM_BITS;
            uint32_t sym = (uint32_t)rem;
            rem = read_byte();
            sym = ((sym << SYM_BITS) | (uint32_t)rem)
                  >> (SYM_BITS - CODE_EXTRA);
            val = ((val << SYM_BITS) + (SYM_MAX & ~sym)) & MASK31;
        }
    }
    void init(const uint8_t* data, int len) {
        buf = data;
        storage = len;
        offs = 0;
        end_offs = 0;
        end_window = 0;
        nend_bits = 0;
        nbits_total = CODE_BITS + 1
                      - ((CODE_BITS - CODE_EXTRA) / SYM_BITS) * SYM_BITS;
        error = 0;
        ext = 0;
        rng = 1u << CODE_EXTRA;
        rem = read_byte();
        val = rng - 1 - (uint32_t)(rem >> (SYM_BITS - CODE_EXTRA));
        normalize();
    }
    uint32_t decode(uint32_t ft) {
        ext = rng / ft;
        uint32_t s = val / ext;
        uint32_t m = s + 1 < ft ? s + 1 : ft;
        return ft - m;
    }
    uint32_t decode_bin(int bits) {
        ext = rng >> bits;
        uint32_t s = val / ext;
        uint32_t ft = 1u << bits;
        uint32_t m = s + 1 < ft ? s + 1 : ft;
        return ft - m;
    }
    void update(uint32_t fl, uint32_t fh, uint32_t ft) {
        uint32_t s = ext * (ft - fh);
        val -= s;
        rng = fl > 0 ? ext * (fh - fl) : rng - s;
        normalize();
    }
    int dec_bit_logp(int logp) {
        uint32_t r = rng;
        uint32_t d = val;
        uint32_t s = r >> logp;
        int ret = d < s;
        if (!ret) val = d - s;
        rng = ret ? s : r - s;
        normalize();
        return ret;
    }
    int dec_icdf(const int* icdf, int ftb) {
        uint32_t s = rng;
        uint32_t d = val;
        uint32_t r = s >> ftb;
        int ret = -1;
        uint32_t t;
        do {
            ret += 1;
            t = s;
            s = r * (uint32_t)icdf[ret];
        } while (d < s);
        val = d - s;
        rng = t - s;
        normalize();
        return ret;
    }
    uint32_t dec_bits(int bits) {
        while (nend_bits < bits) {
            end_window |= (uint64_t)read_byte_from_end() << nend_bits;
            nend_bits += SYM_BITS;
        }
        uint32_t ret = (uint32_t)(end_window & ((1u << bits) - 1));
        end_window >>= bits;
        nend_bits -= bits;
        nbits_total += bits;
        return ret;
    }
    uint32_t dec_uint(uint32_t ft) {
        ft -= 1;
        int ftb = ec_ilog(ft);
        if (ftb > UINT_BITS) {
            ftb -= UINT_BITS;
            uint32_t ft1 = (ft >> ftb) + 1;
            uint32_t s = decode(ft1);
            update(s, s + 1, ft1);
            uint32_t t = (s << ftb) | dec_bits(ftb);
            if (t <= ft) return t;
            error = 1;
            return ft;
        }
        uint32_t s = decode(ft + 1);
        update(s, s + 1, ft + 1);
        return s;
    }
    int tell() const { return nbits_total - ec_ilog(rng); }
    int tell_frac() const {
        static const uint32_t correction[8] = {35733, 38967, 42495, 46340,
                                               50535, 55109, 60097, 65535};
        int nbits = nbits_total << 3;
        int l = ec_ilog(rng);
        uint32_t r = rng >> (l - 16);
        int b = (int)(r >> 12) - 8;
        b += r > correction[b] ? 1 : 0;
        l = (l << 3) + b;
        return nbits - l;
    }
};

// ---- Laplace (pvq.py laplace_decode / laplace.c) ----------------------

constexpr int LAPLACE_MINP = 1;

int laplace_decode(RD& dec, int fs, int decay) {
    int val = 0;
    int fl = 0;
    int fm = (int)dec.decode_bin(15);
    if (fm >= fs) {
        val += 1;
        fl = fs;
        fs = (((32768 - 32 - fs) * (16384 - decay)) >> 15) + LAPLACE_MINP;
        while (fs > LAPLACE_MINP && fm >= fl + 2 * fs) {
            fs *= 2;
            fl += fs;
            fs = (((fs - 2 * LAPLACE_MINP) * decay) >> 15) + LAPLACE_MINP;
            val += 1;
        }
        if (fs <= LAPLACE_MINP) {
            int di = (fm - fl) >> 1;
            val += di;
            fl += 2 * di * LAPLACE_MINP;
        }
        if (fm < fl + fs) val = -val;
        else fl += fs;
    }
    uint32_t fh = (uint32_t)(fl + fs) < 32768u ? (uint32_t)(fl + fs)
                                               : 32768u;
    dec.update((uint32_t)fl, fh, 32768u);
    return val;
}

// ---- CWRS / PVQ (pvq.py) ----------------------------------------------
// V(n,k) memo: every cell reachable from a valid decode (ft < 2^32) is
// itself < 2^32 (V is monotone in both args), so uint64 cells never
// overflow.  0 marks unset; V(n,0)==1 and V(0,k)==0 are handled inline.

constexpr int VMAX_N = 240;
constexpr int VMAX_K = 136;
uint64_t V_memo[VMAX_N + 1][VMAX_K + 1];

uint64_t Vnk(int n, int k) {
    if (k == 0) return 1;
    if (n == 0) return 0;
    uint64_t& cell = V_memo[n][k];
    if (cell == 0) {
        // fill the rectangle below/left of (n,k) iteratively
        for (int ni = 1; ni <= n; ni++)
            for (int ki = 1; ki <= k; ki++) {
                if (V_memo[ni][ki]) continue;
                uint64_t a = ki == 0 ? 1 : (ni - 1 == 0 ? 0
                                            : V_memo[ni - 1][ki]);
                uint64_t b = ki - 1 == 0 ? 1 : V_memo[ni][ki - 1];
                uint64_t c = ki - 1 == 0 ? 1 : (ni - 1 == 0 ? 0
                                                : V_memo[ni - 1][ki - 1]);
                // every value a real decode can touch is < 2^32; clamp
                // larger cells so pathological (n,k) can't overflow
                uint64_t s = a + b + c;
                V_memo[ni][ki] = s > (1ull << 40) ? (1ull << 40) : s;
            }
    }
    return cell;
}

int cwrs_decode(int n, int k, uint32_t index, int* y) {
    for (int j = 0; j < n; j++) y[j] = 0;
    uint64_t i = index;
    for (int j = 0; j < n; j++) {
        if (k == 0) break;
        if (j == n - 1) {
            y[j] = i == 0 ? k : -k;
            k = 0;
            break;
        }
        bool placed = false;
        for (int v = k; v >= 1; v--) {
            uint64_t block = Vnk(n - j - 1, k - v);
            if (i < block) {
                y[j] = v;
                k -= v;
                placed = true;
                break;
            }
            i -= block;
        }
        if (placed) continue;
        uint64_t block = Vnk(n - j - 1, k);
        if (i < block) {
            y[j] = 0;
            continue;
        }
        i -= block;
        for (int v = k; v >= 1; v--) {
            block = Vnk(n - j - 1, k - v);
            if (i < block) {
                y[j] = -v;
                k -= v;
                placed = true;
                break;
            }
            i -= block;
        }
        if (!placed) return -1;  // PVQ index out of range
    }
    return 0;
}

int decode_pulses(RD& dec, int n, int k, int* y) {
    uint64_t ft = Vnk(n, k);
    if (ft >= (1ull << 32)) return -1;
    uint32_t idx = dec.dec_uint((uint32_t)ft);
    return cwrs_decode(n, k, idx, y);
}

// ---- mode wrapper ------------------------------------------------------

struct Mode {
    const int32_t* ebands;       // nb+1
    int nb_ebands;
    int eff_ebands;
    const uint8_t* alloc_vectors;  // nvec x nb
    int nvec;
    const int32_t* logn;         // nb
    const int32_t* cache_index;  // (max_lm+2)*nb
    const uint8_t* cache_bits;
    const uint8_t* cache_caps;
    int short_mdct_size;
};

// ---- allocation (alloc.py / rate.c) -----------------------------------

int get_pulses(int i) {
    return i < 8 ? i : (8 + (i & 7)) << ((i >> 3) - 1);
}

int bits2pulses(const Mode& m, int band, int lm, int bits) {
    const uint8_t* cache = m.cache_bits;
    int off = m.cache_index[(lm + 1) * m.nb_ebands + band];
    int lo = 0, hi = cache[off];
    bits -= 1;
    for (int it = 0; it < LOG_MAX_PSEUDO; it++) {
        int mid = (lo + hi + 1) >> 1;
        if ((int)cache[off + mid] >= bits) hi = mid;
        else lo = mid;
    }
    int low_err = bits - (lo == 0 ? -1 : (int)cache[off + lo]);
    return low_err <= (int)cache[off + hi] - bits ? lo : hi;
}

int pulses2bits(const Mode& m, int band, int lm, int pulses) {
    int off = m.cache_index[(lm + 1) * m.nb_ebands + band];
    return pulses == 0 ? 0 : (int)m.cache_bits[off + pulses] + 1;
}

void init_caps(const Mode& m, int lm, int channels, int* caps) {
    int nb = m.nb_ebands;
    for (int j = 0; j < nb; j++) {
        int n = (m.ebands[j + 1] - m.ebands[j]) << lm;
        caps[j] = ((int)m.cache_caps[(lm * 2 + channels - 1) * nb + j]
                   + 64) * channels * n >> 2;
    }
}

struct Alloc {
    int pulses[25];
    int ebits[25];
    int fine_priority[25];
    int coded_bands;
    int balance;
    int intensity;
    int dual_stereo;
};

void interp_bits2pulses(const Mode& m, int start, int end, int skip_start,
                        const int64_t* bits1, const int64_t* bits2,
                        const int64_t* thresh, const int* cap, int total,
                        int skip_rsv, int intensity_rsv,
                        int dual_stereo_rsv, int C, int lm, RD& dec,
                        Alloc& out) {
    const int32_t* eb = m.ebands;
    int nb = m.nb_ebands;
    int alloc_floor = C << BITRES;
    int stereo = C > 1 ? 1 : 0;
    int logM = lm << BITRES;
    int64_t bits[25] = {0};
    int64_t ebits[25] = {0};
    int64_t fine_priority[25] = {0};

    int lo = 0, hi = 1 << ALLOC_STEPS;
    for (int it = 0; it < ALLOC_STEPS; it++) {
        int mid = (lo + hi) >> 1;
        int64_t psum = 0;
        bool done = false;
        for (int j = end - 1; j >= start; j--) {
            int64_t tmp = bits1[j] + ((int64_t)mid * bits2[j]
                                      >> ALLOC_STEPS);
            if (tmp >= thresh[j] || done) {
                done = true;
                psum += tmp < cap[j] ? tmp : cap[j];
            } else if (tmp >= alloc_floor) {
                psum += alloc_floor;
            }
        }
        if (psum > total) hi = mid;
        else lo = mid;
    }
    int64_t psum = 0;
    bool done = false;
    for (int j = end - 1; j >= start; j--) {
        int64_t tmp = bits1[j] + ((int64_t)lo * bits2[j] >> ALLOC_STEPS);
        if (tmp < thresh[j] && !done) {
            tmp = tmp >= alloc_floor ? alloc_floor : 0;
        } else {
            done = true;
        }
        tmp = tmp < cap[j] ? tmp : cap[j];
        bits[j] = tmp;
        psum += tmp;
    }

    int coded_bands = end;
    while (true) {
        int j = coded_bands - 1;
        if (j <= skip_start) {
            total += skip_rsv;
            break;
        }
        int64_t left = total - psum;
        int64_t denom = eb[coded_bands] - eb[start];
        int64_t percoeff = fdiv64(left, denom);  // Python floor division
        left -= denom * percoeff;
        int64_t rem = left - (eb[j] - eb[start]);
        if (rem < 0) rem = 0;
        int band_width = eb[coded_bands] - eb[j];
        int64_t band_bits = bits[j] + percoeff * band_width + rem;
        int64_t th = thresh[j] > alloc_floor + (1 << BITRES)
                     ? thresh[j] : alloc_floor + (1 << BITRES);
        if (band_bits >= th) {
            if (dec.dec_bit_logp(1)) break;
            psum += 1 << BITRES;
            band_bits -= 1 << BITRES;
        }
        psum -= bits[j] + intensity_rsv;
        if (intensity_rsv > 0) intensity_rsv = LOG2_FRAC[j - start];
        psum += intensity_rsv;
        if (band_bits >= alloc_floor) {
            psum += alloc_floor;
            bits[j] = alloc_floor;
        } else {
            bits[j] = 0;
        }
        coded_bands -= 1;
    }

    int intensity = 0;
    if (intensity_rsv > 0)
        intensity = start + (int)dec.dec_uint(coded_bands + 1 - start);
    if (intensity <= start) {
        total += dual_stereo_rsv;
        dual_stereo_rsv = 0;
    }
    int dual_stereo = dual_stereo_rsv > 0 ? dec.dec_bit_logp(1) : 0;

    int64_t left = total - psum;
    int64_t denom = eb[coded_bands] - eb[start];
    int64_t percoeff = fdiv64(left, denom);
    left -= denom * percoeff;
    for (int j = start; j < coded_bands; j++)
        bits[j] += percoeff * (eb[j + 1] - eb[j]);
    for (int j = start; j < coded_bands; j++) {
        int64_t tmp = left < eb[j + 1] - eb[j] ? left : eb[j + 1] - eb[j];
        bits[j] += tmp;
        left -= tmp;
    }

    int64_t balance = 0;
    for (int j = start; j < coded_bands; j++) {
        int n0 = eb[j + 1] - eb[j];
        int n = n0 << lm;
        int64_t bit = bits[j] + balance;
        int64_t excess = 0;
        if (n > 1) {
            excess = bit - cap[j] > 0 ? bit - cap[j] : 0;
            bits[j] = bit - excess;
            int den = C * n + ((C == 2 && n > 2 && !dual_stereo
                                && j < intensity) ? 1 : 0);
            int nclogn = den * (m.logn[j] + logM);
            int64_t offset = (nclogn >> 1) - (int64_t)den * FINE_OFFSET;
            if (n == 2) offset += den << BITRES >> 2;
            if (bits[j] + offset < (int64_t)(den * 2) << BITRES)
                offset += nclogn >> 2;
            else if (bits[j] + offset < (int64_t)(den * 3) << BITRES)
                offset += nclogn >> 3;
            int64_t eb_j = bits[j] + offset + ((int64_t)den
                                               << (BITRES - 1));
            if (eb_j < 0) eb_j = 0;
            eb_j = (eb_j / den) >> BITRES;
            if (C * eb_j > (bits[j] >> BITRES))
                eb_j = bits[j] >> stereo >> BITRES;
            if (eb_j > MAX_FINE_BITS) eb_j = MAX_FINE_BITS;
            fine_priority[j] = eb_j * ((int64_t)den << BITRES)
                               >= bits[j] + offset ? 1 : 0;
            ebits[j] = eb_j;
            bits[j] -= (int64_t)C * eb_j << BITRES;
        } else {
            excess = bit - (C << BITRES) > 0 ? bit - (C << BITRES) : 0;
            bits[j] = bit - excess;
            ebits[j] = 0;
            fine_priority[j] = 1;
        }
        if (excess > 0) {
            int64_t extra_fine = excess >> (stereo + BITRES);
            if (extra_fine > MAX_FINE_BITS - ebits[j])
                extra_fine = MAX_FINE_BITS - ebits[j];
            ebits[j] += extra_fine;
            int64_t extra_bits = extra_fine * C << BITRES;
            fine_priority[j] = extra_bits >= excess - balance ? 1 : 0;
            excess -= extra_bits;
        }
        balance = excess;
    }

    for (int j = coded_bands; j < end; j++) {
        ebits[j] = bits[j] >> stereo >> BITRES;
        bits[j] = 0;
        fine_priority[j] = ebits[j] < 1 ? 1 : 0;
    }

    for (int j = 0; j < nb; j++) {
        out.pulses[j] = (int)bits[j];
        out.ebits[j] = (int)ebits[j];
        out.fine_priority[j] = (int)fine_priority[j];
    }
    out.coded_bands = coded_bands;
    out.balance = (int)balance;
    out.intensity = intensity;
    out.dual_stereo = dual_stereo;
}

void compute_allocation(const Mode& m, int start, int end,
                        const int64_t* offsets, const int* cap,
                        int alloc_trim, int total, int channels, int lm,
                        RD& dec, Alloc& out) {
    const int32_t* eb = m.ebands;
    int nb = m.nb_ebands;
    int nvec = m.nvec;
    int C = channels;
    if (total < 0) total = 0;
    int skip_start = start;
    int skip_rsv = total >= (1 << BITRES) ? (1 << BITRES) : 0;
    total -= skip_rsv;
    int intensity_rsv = 0, dual_stereo_rsv = 0;
    if (C == 2) {
        intensity_rsv = LOG2_FRAC[end - start];
        if (intensity_rsv > total) {
            intensity_rsv = 0;
        } else {
            total -= intensity_rsv;
            dual_stereo_rsv = total >= (1 << BITRES) ? (1 << BITRES) : 0;
            total -= dual_stereo_rsv;
        }
    }

    int64_t thresh[25], trim_offset[25];
    for (int j = start; j < end; j++) {
        int n = eb[j + 1] - eb[j];
        int64_t t = (int64_t)(3 * n << lm << BITRES) >> 4;
        thresh[j] = t > (C << BITRES) ? t : (C << BITRES);
        trim_offset[j] = ((int64_t)C * n * (alloc_trim - 5 - lm)
                          * (end - j - 1) * (1 << (lm + BITRES))) >> 6;
        if ((n << lm) == 1) trim_offset[j] -= C << BITRES;
    }

    auto vec_bits = [&](int vec, int j) -> int64_t {
        int n = eb[j + 1] - eb[j];
        return (int64_t)C * n * m.alloc_vectors[vec * nb + j] << lm >> 2;
    };

    int lo = 1, hi = nvec - 1;
    while (lo <= hi) {
        int mid = (lo + hi) >> 1;
        bool done = false;
        int64_t psum = 0;
        for (int j = end - 1; j >= start; j--) {
            int64_t b = vec_bits(mid, j);
            if (b > 0) {
                b = b + trim_offset[j];
                if (b < 0) b = 0;
            }
            b += offsets[j];
            if (b >= thresh[j] || done) {
                done = true;
                psum += b < cap[j] ? b : cap[j];
            } else if (b >= (C << BITRES)) {
                psum += C << BITRES;
            }
        }
        if (psum > total) hi = mid - 1;
        else lo = mid + 1;
    }
    hi = lo;
    lo -= 1;

    int64_t bits1[25] = {0}, bits2[25] = {0};
    for (int j = start; j < end; j++) {
        int64_t b1 = vec_bits(lo, j);
        int64_t b2 = hi >= nvec ? cap[j] : vec_bits(hi, j);
        if (b1 > 0) {
            b1 = b1 + trim_offset[j];
            if (b1 < 0) b1 = 0;
        }
        if (b2 > 0) {
            b2 = b2 + trim_offset[j];
            if (b2 < 0) b2 = 0;
        }
        if (lo > 0) b1 += offsets[j];
        b2 += offsets[j];
        if (offsets[j] > 0) skip_start = j;
        bits1[j] = b1;
        bits2[j] = b2 - b1 > 0 ? b2 - b1 : 0;
    }

    interp_bits2pulses(m, start, end, skip_start, bits1, bits2, thresh,
                       cap, total, skip_rsv, intensity_rsv,
                       dual_stereo_rsv, C, lm, dec, out);
}

// ---- band decode (celt.py _quant_* stack) -----------------------------

inline int frac_mul16(int a, int b) { return (16384 + a * b) >> 15; }

int bitexact_cos(int x) {
    int tmp = (4096 + x * x) >> 13;
    int x2 = tmp;
    x2 = (32767 - x2)
         + frac_mul16(x2, -7651 + frac_mul16(x2,
                                             8277 + frac_mul16(-626, x2)));
    return 1 + x2;
}

int bitexact_log2tan(int isin, int icos) {
    int lc = ec_ilog((uint32_t)icos);
    int ls = ec_ilog((uint32_t)isin);
    icos <<= 15 - lc;
    isin <<= 15 - ls;
    return (ls - lc) * (1 << 11)
           + frac_mul16(isin, frac_mul16(isin, -2597) + 7932)
           - frac_mul16(icos, frac_mul16(icos, -2597) + 7932);
}

uint32_t isqrt64(uint64_t v) {
    if (v == 0) return 0;
    uint64_t r = (uint64_t)std::sqrt((double)v);
    while (r * r > v) r--;
    while ((r + 1) * (r + 1) <= v) r++;
    return (uint32_t)r;
}

struct BandCtx {
    int i;
    int intensity;
    int spread;
    int tf_change;
    RD* dec;
    int64_t remaining_bits;
    uint32_t seed;
    int disable_inv;
    const Mode* mode;
};

int compute_qn(int n, int b, int offset, int pulse_cap, bool stereo) {
    static const int exp2_table8[8] = {16384, 17866, 19483, 21247,
                                       23170, 25267, 27554, 30048};
    int n2 = 2 * n - 1;
    if (stereo && n == 2) n2 -= 1;
    int qb = cdiv(b + n2 * offset, n2);
    int v = b - pulse_cap - (4 << BITRES);
    if (v < qb) qb = v;
    if (qb > (8 << BITRES)) qb = 8 << BITRES;
    if (qb < (1 << BITRES >> 1)) return 1;
    int qn = exp2_table8[qb & 0x7] >> (14 - (qb >> BITRES));
    return (qn + 1) >> 1 << 1;
}

struct Theta {
    int b;
    int fill;
    int inv;
    int imid;
    int iside;
    int delta;
    int itheta;
    int qalloc;
};

Theta compute_theta(BandCtx& ctx, int N, int b, int B, int B0, int LM,
                    bool stereo, int fill) {
    const Mode& m = *ctx.mode;
    RD& dec = *ctx.dec;
    int pulse_cap = m.logn[ctx.i] + LM * (1 << BITRES);
    int offset = (pulse_cap >> 1)
                 - (stereo && N == 2 ? QTHETA_OFFSET_TWOPHASE
                                     : QTHETA_OFFSET);
    int qn = compute_qn(N, b, offset, pulse_cap, stereo);
    if (stereo && ctx.i >= ctx.intensity) qn = 1;
    int tell = dec.tell_frac();
    int inv = 0;
    int itheta = 0;
    if (qn != 1) {
        if (stereo && N > 2) {
            int p0 = 3;
            int x0 = qn / 2;
            uint32_t ft = (uint32_t)(p0 * (x0 + 1) + x0);
            uint32_t fs = dec.decode(ft);
            int x;
            if ((int)fs < (x0 + 1) * p0) x = (int)fs / p0;
            else x = x0 + 1 + ((int)fs - (x0 + 1) * p0);
            uint32_t fl = x <= x0 ? (uint32_t)(p0 * x)
                                  : (uint32_t)((x - 1 - x0)
                                               + (x0 + 1) * p0);
            uint32_t fh = x <= x0 ? (uint32_t)(p0 * (x + 1))
                                  : (uint32_t)((x - x0) + (x0 + 1) * p0);
            dec.update(fl, fh, ft);
            itheta = x;
        } else if (B0 > 1 || stereo) {
            itheta = (int)dec.dec_uint(qn + 1);
        } else {
            int ft = ((qn >> 1) + 1) * ((qn >> 1) + 1);
            int fm = (int)dec.decode((uint32_t)ft);
            int fs, fl;
            if (fm < ((qn >> 1) * ((qn >> 1) + 1) >> 1)) {
                itheta = (int)((isqrt64(8ull * fm + 1) - 1) >> 1);
                fs = itheta + 1;
                fl = itheta * (itheta + 1) >> 1;
            } else {
                itheta = (int)((2 * (qn + 1)
                                - isqrt64(8ull * (ft - fm - 1) + 1)) >> 1);
                fs = qn + 1 - itheta;
                fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1);
            }
            dec.update((uint32_t)fl, (uint32_t)(fl + fs), (uint32_t)ft);
        }
        itheta = itheta * 16384 / qn;
    } else if (stereo) {
        if (b > 2 << BITRES && ctx.remaining_bits > 2 << BITRES)
            inv = dec.dec_bit_logp(2);
        else
            inv = 0;
        if (ctx.disable_inv) inv = 0;
        itheta = 0;
    }
    int qalloc = dec.tell_frac() - tell;
    b -= qalloc;
    Theta t;
    if (itheta == 0) {
        t.imid = 32767;
        t.iside = 0;
        fill &= (1 << B) - 1;
        t.delta = -16384;
    } else if (itheta == 16384) {
        t.imid = 0;
        t.iside = 32767;
        fill &= ((1 << B) - 1) << B;
        t.delta = 16384;
    } else {
        t.imid = bitexact_cos(itheta);
        t.iside = bitexact_cos(16384 - itheta);
        t.delta = frac_mul16((N - 1) << 7,
                             bitexact_log2tan(t.iside, t.imid));
    }
    t.b = b;
    t.fill = fill;
    t.inv = inv;
    t.itheta = itheta;
    t.qalloc = qalloc;
    return t;
}

int quant_band_n1(BandCtx& ctx, double* X, double* Y, double* lowband_out) {
    double* x = X;
    for (int rep = 0; rep < (Y ? 2 : 1); rep++) {
        int sign = 0;
        if (ctx.remaining_bits >= 1 << BITRES) {
            sign = (int)ctx.dec->dec_bits(1);
            ctx.remaining_bits -= 1 << BITRES;
        }
        x[0] = sign ? -1.0 : 1.0;
        x = Y;
    }
    if (lowband_out) lowband_out[0] = X[0];
    return 1;
}

const int ORDERY2[2] = {1, 0};
const int ORDERY4[4] = {3, 0, 2, 1};
const int ORDERY8[8] = {7, 0, 4, 3, 6, 1, 5, 2};
const int ORDERY16[16] = {15, 0, 8, 7, 12, 3, 11, 4,
                          14, 1, 9, 6, 13, 2, 10, 5};

const int* ordery_table(int stride) {
    switch (stride) {
        case 2: return ORDERY2;
        case 4: return ORDERY4;
        case 8: return ORDERY8;
        case 16: return ORDERY16;
    }
    return nullptr;
}

void deinterleave_hadamard(double* X, int n0, int stride, bool hadamard) {
    double tmp[256];
    int total = n0 * stride;
    if (hadamard) {
        const int* ordery = ordery_table(stride);
        for (int i = 0; i < stride; i++)
            for (int j = 0; j < n0; j++)
                tmp[ordery[i] * n0 + j] = X[j * stride + i];
    } else {
        for (int i = 0; i < stride; i++)
            for (int j = 0; j < n0; j++)
                tmp[i * n0 + j] = X[j * stride + i];
    }
    std::memcpy(X, tmp, total * sizeof(double));
}

void interleave_hadamard(double* X, int n0, int stride, bool hadamard) {
    double tmp[256];
    int total = n0 * stride;
    if (hadamard) {
        const int* ordery = ordery_table(stride);
        for (int i = 0; i < stride; i++)
            for (int j = 0; j < n0; j++)
                tmp[j * stride + i] = X[ordery[i] * n0 + j];
    } else {
        for (int i = 0; i < stride; i++)
            for (int j = 0; j < n0; j++)
                tmp[j * stride + i] = X[i * n0 + j];
    }
    std::memcpy(X, tmp, total * sizeof(double));
}

void haar1(double* X, int n0, int stride) {
    n0 >>= 1;
    const double s = 0.70710678;
    for (int i = 0; i < stride; i++)
        for (int j = 0; j < n0; j++) {
            double a = X[i + stride * 2 * j];
            double b = X[i + stride * (2 * j + 1)];
            X[i + stride * 2 * j] = s * (a + b);
            X[i + stride * (2 * j + 1)] = s * (a - b);
        }
}

void exp_rotation1(double* X, int length, int stride, double c, double s) {
    double ms = -s;
    for (int i = 0; i < length - stride; i++) {
        double x1 = X[i];
        double x2 = X[i + stride];
        double t1 = c * x2;
        double t2 = s * x1;
        X[i + stride] = t1 + t2;
        double t3 = c * x1;
        double t4 = ms * x2;
        X[i] = t3 + t4;
    }
    for (int i = length - 2 * stride - 1; i >= 0; i--) {
        double x1 = X[i];
        double x2 = X[i + stride];
        double t1 = c * x2;
        double t2 = s * x1;
        X[i + stride] = t1 + t2;
        double t3 = c * x1;
        double t4 = ms * x2;
        X[i] = t3 + t4;
    }
}

void exp_rotation(double* X, int length, int direction, int stride, int K,
                  int spread) {
    static const int factor_tab[3] = {15, 10, 5};
    if (2 * K >= length || spread == SPREAD_NONE) return;
    int factor = factor_tab[spread - 1];
    double gain = 1.0 * length / (length + factor * K);
    double theta = 0.5 * gain * gain;
    double c = std::cos(0.5 * M_PI * theta);
    double s = std::cos(0.5 * M_PI * (1.0 - theta));
    int stride2 = 0;
    if (length >= 8 * stride) {
        stride2 = 1;
        while ((stride2 * stride2 + stride2) * stride + (stride >> 2)
               < length)
            stride2 += 1;
    }
    length /= stride;
    for (int i = 0; i < stride; i++) {
        int off = i * length;
        if (direction < 0) {
            if (stride2)
                exp_rotation1(X + off, length, stride2, s, c);
            exp_rotation1(X + off, length, 1, c, s);
        } else {
            exp_rotation1(X + off, length, 1, c, -s);
            if (stride2)
                exp_rotation1(X + off, length, stride2, s, -c);
        }
    }
}

int extract_collapse_mask(const int* iy, int N, int B) {
    if (B <= 1) return 1;
    int n0 = N / B;
    int mask = 0;
    for (int i = 0; i < B; i++) {
        bool any = false;
        for (int j = 0; j < n0; j++)
            if (iy[i * n0 + j]) { any = true; break; }
        if (any) mask |= 1 << i;
    }
    return mask;
}

int alg_unquant(BandCtx& ctx, double* X, int N, int K, int spread, int B,
                double gain, int* err) {
    int iy[256];
    if (decode_pulses(*ctx.dec, N, K, iy) != 0) {
        *err = 1;
        return 0;
    }
    double ryy = 0.0;
    for (int j = 0; j < N; j++) ryy += (double)iy[j] * (double)iy[j];
    double g = gain / std::sqrt(ryy);
    for (int j = 0; j < N; j++) X[j] = g * iy[j];
    exp_rotation(X, N, -1, B, K, spread);
    return extract_collapse_mask(iy, N, B);
}

int quant_partition(BandCtx& ctx, double* X, int N, int b, int B,
                    double* lowband, int LM, double gain, int fill,
                    int* err) {
    const Mode& m = *ctx.mode;
    int i = ctx.i;
    int B0 = B;
    int cache_off = m.cache_index[(LM + 1) * m.nb_ebands + i];
    const uint8_t* cache = m.cache_bits;
    if (LM != -1 && N > 2
        && b > (int)cache[cache_off + cache[cache_off]] + 12) {
        N >>= 1;
        double* Y = X + N;
        LM -= 1;
        if (B == 1) fill = (fill & 1) | (fill << 1);
        B = (B + 1) >> 1;
        Theta t = compute_theta(ctx, N, b, B, B0, LM, false, fill);
        b = t.b;
        fill = t.fill;
        double mid = t.imid / 32768.0;
        double side = t.iside / 32768.0;
        int delta = t.delta;
        if (B0 > 1 && (t.itheta & 0x3FFF)) {
            if (t.itheta > 8192) {
                delta -= delta >> (4 - LM);
            } else {
                int v = delta + (N << BITRES >> (5 - LM));
                delta = v < 0 ? v : 0;
            }
        }
        int mbits = cdiv(b - delta, 2);
        if (mbits > b) mbits = b;
        if (mbits < 0) mbits = 0;
        int sbits = b - mbits;
        ctx.remaining_bits -= t.qalloc;
        double* next_lowband2 = lowband ? lowband + N : nullptr;
        int64_t rebalance = ctx.remaining_bits;
        int cm;
        if (mbits >= sbits) {
            cm = quant_partition(ctx, X, N, mbits, B, lowband, LM,
                                 gain * mid, fill, err);
            rebalance = mbits - (rebalance - ctx.remaining_bits);
            if (rebalance > 3 << BITRES && t.itheta != 0)
                sbits += (int)rebalance - (3 << BITRES);
            cm |= quant_partition(ctx, Y, N, sbits, B, next_lowband2, LM,
                                  gain * side, fill >> B, err) << (B0 >> 1);
        } else {
            cm = quant_partition(ctx, Y, N, sbits, B, next_lowband2, LM,
                                 gain * side, fill >> B, err) << (B0 >> 1);
            rebalance = sbits - (rebalance - ctx.remaining_bits);
            if (rebalance > 3 << BITRES && t.itheta != 16384)
                mbits += (int)rebalance - (3 << BITRES);
            cm |= quant_partition(ctx, X, N, mbits, B, lowband, LM,
                                  gain * mid, fill, err);
        }
        return cm;
    }
    // no-split leaf
    int q = bits2pulses(m, i, LM, b);
    int curr_bits = pulses2bits(m, i, LM, q);
    ctx.remaining_bits -= curr_bits;
    while (ctx.remaining_bits < 0 && q > 0) {
        ctx.remaining_bits += curr_bits;
        q -= 1;
        curr_bits = pulses2bits(m, i, LM, q);
        ctx.remaining_bits -= curr_bits;
    }
    if (q != 0) {
        int K = get_pulses(q);
        return alg_unquant(ctx, X, N, K, ctx.spread, B, gain, err);
    }
    // no pulses: noise/fold fill
    int cm_mask = (1 << B) - 1;
    fill &= cm_mask;
    if (!fill) {
        for (int j = 0; j < N; j++) X[j] = 0.0;
        return 0;
    }
    int cm;
    if (lowband == nullptr) {
        for (int j = 0; j < N; j++) {
            ctx.seed = lcg(ctx.seed);
            int32_t s32 = (int32_t)ctx.seed;
            X[j] = (double)(s32 >> 20);
        }
        cm = cm_mask;
    } else {
        for (int j = 0; j < N; j++) {
            ctx.seed = lcg(ctx.seed);
            double tmp = (ctx.seed & 0x8000) ? 1.0 / 256 : -1.0 / 256;
            X[j] = lowband[j] + tmp;
        }
        cm = fill;
    }
    double e = 0.0;
    for (int j = 0; j < N; j++) e += X[j] * X[j];
    e += 1e-15;
    double g = gain / std::sqrt(e);
    for (int j = 0; j < N; j++) X[j] *= g;
    return cm;
}

const int BIT_INTERLEAVE[16] = {0, 1, 1, 1, 2, 3, 3, 3,
                                2, 3, 3, 3, 2, 3, 3, 3};
const int BIT_DEINTERLEAVE[16] = {0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33,
                                  0x3C, 0x3F, 0xC0, 0xC3, 0xCC, 0xCF,
                                  0xF0, 0xF3, 0xFC, 0xFF};

int quant_band(BandCtx& ctx, double* X, int N, int b, int B,
               double* lowband, int LM, double* lowband_out, double gain,
               double* lowband_scratch, int fill, int* err) {
    int N0 = N;
    int N_B = N / B;
    int B0 = B;
    int time_divide = 0;
    int recombine = 0;
    bool long_blocks = B0 == 1;
    int tf_change = ctx.tf_change;
    if (N == 1) return quant_band_n1(ctx, X, nullptr, lowband_out);
    if (tf_change > 0) recombine = tf_change;
    if (lowband_scratch && lowband
        && (recombine || ((N_B & 1) == 0 && tf_change < 0) || B0 > 1)) {
        std::memcpy(lowband_scratch, lowband, N * sizeof(double));
        lowband = lowband_scratch;
    }
    for (int k = 0; k < recombine; k++) {
        if (lowband) haar1(lowband, N >> k, 1 << k);
        fill = BIT_INTERLEAVE[fill & 0xF]
               | BIT_INTERLEAVE[fill >> 4] << 2;
    }
    B >>= recombine;
    N_B <<= recombine;
    while ((N_B & 1) == 0 && tf_change < 0) {
        if (lowband) haar1(lowband, N_B, B);
        fill |= fill << B;
        B <<= 1;
        N_B >>= 1;
        time_divide += 1;
        tf_change += 1;
    }
    B0 = B;
    int N_B0 = N_B;
    if (B0 > 1 && lowband)
        deinterleave_hadamard(lowband, N_B >> recombine,
                              B0 << recombine, long_blocks);
    int cm = quant_partition(ctx, X, N, b, B, lowband, LM, gain, fill,
                             err);
    if (B0 > 1)
        interleave_hadamard(X, N_B >> recombine, B0 << recombine,
                            long_blocks);
    N_B = N_B0;
    B = B0;
    for (int k = 0; k < time_divide; k++) {
        B >>= 1;
        N_B <<= 1;
        cm |= cm >> B;
        haar1(X, N_B, B);
    }
    for (int k = 0; k < recombine; k++) {
        cm = BIT_DEINTERLEAVE[cm];
        haar1(X, N0 >> k, 1 << k);
    }
    B <<= recombine;
    if (lowband_out) {
        double n = std::sqrt((double)N0);
        for (int j = 0; j < N0; j++) lowband_out[j] = n * X[j];
    }
    return cm & ((1 << B) - 1);
}

void stereo_merge(double* X, double* Y, double mid, int N) {
    double xp = 0.0, side = 0.0;
    for (int j = 0; j < N; j++) xp += Y[j] * X[j];
    xp *= mid;
    for (int j = 0; j < N; j++) side += Y[j] * Y[j];
    double mid2 = mid;
    double el = mid2 * mid2 + side - 2 * xp;
    double er = mid2 * mid2 + side + 2 * xp;
    if (er < 6e-4 || el < 6e-4) {
        std::memcpy(Y, X, N * sizeof(double));
        return;
    }
    double lgain = 1.0 / std::sqrt(el);
    double rgain = 1.0 / std::sqrt(er);
    for (int j = 0; j < N; j++) {
        double l = mid * X[j];
        double r = Y[j];
        X[j] = lgain * (l - r);
        Y[j] = rgain * (l + r);
    }
}

int quant_band_stereo(BandCtx& ctx, double* X, double* Y, int N, int b,
                      int B, double* lowband, int LM, double* lowband_out,
                      double* lowband_scratch, int fill, int* err) {
    if (N == 1) return quant_band_n1(ctx, X, Y, lowband_out);
    int orig_fill = fill;
    Theta t = compute_theta(ctx, N, b, B, B, LM, true, fill);
    b = t.b;
    fill = t.fill;
    double mid = t.imid / 32768.0;
    double side = t.iside / 32768.0;
    int cm;
    if (N == 2) {
        int mbits = b;
        int sbits = 0;
        if (t.itheta != 0 && t.itheta != 16384) sbits = 1 << BITRES;
        mbits -= sbits;
        bool c = t.itheta > 8192;
        ctx.remaining_bits -= t.qalloc + sbits;
        double* x2 = c ? Y : X;
        double* y2 = c ? X : Y;
        int sign = 0;
        if (sbits) sign = (int)ctx.dec->dec_bits(1);
        sign = 1 - 2 * sign;
        cm = quant_band(ctx, x2, N, mbits, B, lowband, LM, lowband_out,
                        1.0, lowband_scratch, orig_fill, err);
        y2[0] = -sign * x2[1];
        y2[1] = sign * x2[0];
        X[0] *= mid;
        X[1] *= mid;
        Y[0] *= side;
        Y[1] *= side;
        double tmp = X[0];
        X[0] = tmp - Y[0];
        Y[0] = tmp + Y[0];
        tmp = X[1];
        X[1] = tmp - Y[1];
        Y[1] = tmp + Y[1];
    } else {
        int mbits = cdiv(b - t.delta, 2);
        if (mbits > b) mbits = b;
        if (mbits < 0) mbits = 0;
        int sbits = b - mbits;
        ctx.remaining_bits -= t.qalloc;
        int64_t rebalance = ctx.remaining_bits;
        if (mbits >= sbits) {
            cm = quant_band(ctx, X, N, mbits, B, lowband, LM,
                            lowband_out, 1.0, lowband_scratch, fill, err);
            rebalance = mbits - (rebalance - ctx.remaining_bits);
            if (rebalance > 3 << BITRES && t.itheta != 0)
                sbits += (int)rebalance - (3 << BITRES);
            cm |= quant_band(ctx, Y, N, sbits, B, nullptr, LM, nullptr,
                             side, nullptr, fill >> B, err);
        } else {
            cm = quant_band(ctx, Y, N, sbits, B, nullptr, LM, nullptr,
                            side, nullptr, fill >> B, err);
            rebalance = sbits - (rebalance - ctx.remaining_bits);
            if (rebalance > 3 << BITRES && t.itheta != 16384)
                mbits += (int)rebalance - (3 << BITRES);
            cm |= quant_band(ctx, X, N, mbits, B, lowband, LM,
                             lowband_out, 1.0, lowband_scratch, fill, err);
        }
    }
    if (N != 2) stereo_merge(X, Y, mid, N);
    if (t.inv) {
        for (int j = 0; j < N; j++) Y[j] = -Y[j];
    }
    return cm;
}

}  // namespace

// ---- exported entry ----------------------------------------------------

extern "C" int celt_entropy_decode(
    const uint8_t* data, int storage,
    // range-decoder state handoff: st64[0]!=0 -> load offs, end_offs,
    // end_window, nend_bits, nbits_total, rng, rem, val, error from
    // st64[1..9]; always written back on return
    int64_t* st64,
    int C, int LM, int start, int end, int loss_duration,
    // mode tables
    const int32_t* ebands, int nb_ebands, int eff_ebands,
    const uint8_t* alloc_vectors, int nvec, const int32_t* logn,
    const int32_t* cache_index, const uint8_t* cache_bits,
    const uint8_t* cache_caps, int short_mdct_size,
    // decoder state
    float* old_ebands, const float* old_logE, const float* old_logE2,
    uint32_t* seed_io,
    // outputs
    double* X, int32_t* flags_out, double* pf_gain_out) {
    Mode m;
    m.ebands = ebands;
    m.nb_ebands = nb_ebands;
    m.eff_ebands = eff_ebands;
    m.alloc_vectors = alloc_vectors;
    m.nvec = nvec;
    m.logn = logn;
    m.cache_index = cache_index;
    m.cache_bits = cache_bits;
    m.cache_caps = cache_caps;
    m.short_mdct_size = short_mdct_size;

    int nb = nb_ebands;
    int M = 1 << LM;
    int N = M * short_mdct_size;
    const int32_t* eb = ebands;

    RD dec;
    if (st64[0]) {
        dec.buf = data;
        dec.storage = storage;
        dec.offs = (int)st64[1];
        dec.end_offs = (int)st64[2];
        dec.end_window = (uint64_t)st64[3];
        dec.nend_bits = (int)st64[4];
        dec.nbits_total = (int)st64[5];
        dec.rng = (uint32_t)st64[6];
        dec.rem = (int)st64[7];
        dec.val = (uint32_t)st64[8];
        dec.error = (int)st64[9];
        dec.ext = 0;
    } else {
        dec.init(data, storage);
    }

    int total_bits = storage * 8;
    int tell = dec.tell();
    int silence;
    if (tell >= total_bits) silence = 1;
    else if (tell == 1) silence = dec.dec_bit_logp(15);
    else silence = 0;
    if (silence) {
        dec.nbits_total += total_bits - dec.tell();
        tell = total_bits;
    }
    double pf_gain = 0.0;
    int pf_pitch = 0;
    int pf_tapset = 0;
    if (start == 0 && tell + 16 <= total_bits) {
        if (dec.dec_bit_logp(1)) {
            int octave = (int)dec.dec_uint(6);
            pf_pitch = (16 << octave) + (int)dec.dec_bits(4 + octave) - 1;
            int qg = (int)dec.dec_bits(3);
            if (dec.tell() + 2 <= total_bits)
                pf_tapset = dec.dec_icdf(TAPSET_ICDF, 2);
            pf_gain = 0.09375 * (qg + 1);
        }
        tell = dec.tell();
    }
    int is_transient = 0;
    if (LM > 0 && tell + 3 <= total_bits) {
        is_transient = dec.dec_bit_logp(3);
        tell = dec.tell();
    }
    int short_blocks = is_transient ? M : 0;
    int intra_ener = tell + 3 <= total_bits ? dec.dec_bit_logp(3) : 0;
    if (!intra_ener && loss_duration != 0) {
        // post-loss energy safety clamp (celt_decoder.c:1171-1197)
        float safety = LM == 0 ? 1.5f : (LM == 1 ? 0.5f : 0.0f);
        int missing = loss_duration >> LM;
        if (missing > 10) missing = 10;
        for (int c = 0; c < 2; c++)
            for (int i = start; i < end; i++) {
                int k = c * nb + i;
                float lo = old_logE[k] > old_logE2[k] ? old_logE[k]
                                                      : old_logE2[k];
                if (old_ebands[k] < lo) {
                    float s1 = old_logE[k] - old_ebands[k];
                    float s2 = 0.5f * (old_logE2[k] - old_ebands[k]);
                    float slope = s1 > s2 ? s1 : s2;
                    float dec_amt = (1 + missing) * slope;
                    if (dec_amt < 0.0f) dec_amt = 0.0f;
                    float v = old_ebands[k] - dec_amt;
                    old_ebands[k] = v > -20.0f ? v : -20.0f;
                } else {
                    float v = old_ebands[k];
                    if (old_logE[k] < v) v = old_logE[k];
                    if (old_logE2[k] < v) v = old_logE2[k];
                    old_ebands[k] = v;
                }
                old_ebands[k] -= safety;
            }
    }
    // coarse energy (celt.py _unquant_coarse_energy)
    {
        const int* prob = E_PROB_MODEL[LM][intra_ener ? 1 : 0];
        float coef, beta;
        if (intra_ener) {
            coef = 0.0f;
            beta = (float)BETA_INTRA;
        } else {
            beta = (float)BETA_COEF[LM];
            coef = (float)PRED_COEF[LM];
        }
        int budget = total_bits;
        float prev[2] = {0.0f, 0.0f};
        for (int i = start; i < end; i++)
            for (int c = 0; c < C; c++) {
                int t2 = dec.tell();
                int qi;
                if (budget - t2 >= 15) {
                    int pi = 2 * (i < 20 ? i : 20);
                    qi = laplace_decode(dec, prob[pi] << 7,
                                        prob[pi + 1] << 6);
                } else if (budget - t2 >= 2) {
                    qi = dec.dec_icdf(SMALL_ENERGY_ICDF, 2);
                    qi = (qi >> 1) ^ -(qi & 1);
                } else if (budget - t2 >= 1) {
                    qi = -dec.dec_bit_logp(1);
                } else {
                    qi = -1;
                }
                float q = (float)qi;
                int k = i + c * nb;
                if (old_ebands[k] < -9.0f) old_ebands[k] = -9.0f;
                float t1 = coef * old_ebands[k];
                float t3 = t1 + prev[c];
                float tmp = t3 + q;
                old_ebands[k] = tmp;
                float t4 = prev[c] + q;
                float t5 = beta * q;
                prev[c] = t4 - t5;
            }
    }
    // tf_decode
    int tf_res[25];
    {
        int budget = total_bits;
        int t2 = dec.tell();
        int logp = is_transient ? 2 : 4;
        int tf_select_rsv = (LM > 0 && t2 + logp + 1 <= budget) ? 1 : 0;
        budget -= tf_select_rsv;
        int tf_changed = 0, curr = 0;
        for (int i = start; i < end; i++) {
            if (t2 + logp <= budget) {
                curr ^= dec.dec_bit_logp(logp);
                t2 = dec.tell();
                tf_changed |= curr;
            }
            tf_res[i] = curr;
            logp = is_transient ? 4 : 5;
        }
        int tf_select = 0;
        const int* row = TF_SELECT_TABLE[LM];
        if (tf_select_rsv
            && row[4 * is_transient + 0 + tf_changed]
               != row[4 * is_transient + 2 + tf_changed])
            tf_select = dec.dec_bit_logp(1);
        for (int i = start; i < end; i++)
            tf_res[i] = row[4 * is_transient + 2 * tf_select + tf_res[i]];
    }
    tell = dec.tell();
    int spread = 2;  // SPREAD_NORMAL
    if (tell + 4 <= total_bits) spread = dec.dec_icdf(SPREAD_ICDF, 5);
    int cap[25];
    init_caps(m, LM, C, cap);
    int64_t offsets[25] = {0};
    {
        int dynalloc_logp = 6;
        int64_t total_bits_f = (int64_t)total_bits << BITRES;
        int64_t tell_f = dec.tell_frac();
        for (int i = start; i < end; i++) {
            int width = C * (eb[i + 1] - eb[i]) << LM;
            int quanta = width << BITRES;
            int mx = 6 << BITRES > width ? 6 << BITRES : width;
            if (quanta > mx) quanta = mx;
            int dynalloc_loop_logp = dynalloc_logp;
            int64_t boost = 0;
            while (tell_f + ((int64_t)dynalloc_loop_logp << BITRES)
                       < total_bits_f
                   && boost < cap[i]) {
                int flag = dec.dec_bit_logp(dynalloc_loop_logp);
                tell_f = dec.tell_frac();
                if (!flag) break;
                boost += quanta;
                total_bits_f -= quanta;
                dynalloc_loop_logp = 1;
            }
            offsets[i] = boost;
            if (boost > 0)
                dynalloc_logp = dynalloc_logp - 1 > 2
                                ? dynalloc_logp - 1 : 2;
        }
        int alloc_trim = 5;
        if (tell_f + (6 << BITRES) <= total_bits_f)
            alloc_trim = dec.dec_icdf(TRIM_ICDF, 7);
        int64_t bits = ((int64_t)storage * 8 << BITRES)
                       - dec.tell_frac() - 1;
        int anti_collapse_rsv = (is_transient && LM >= 2
                                 && bits >= ((int64_t)(LM + 2) << BITRES))
                                ? (1 << BITRES) : 0;
        bits -= anti_collapse_rsv;
        Alloc a;
        compute_allocation(m, start, end, offsets, cap, alloc_trim,
                           (int)bits, C, LM, dec, a);
        // fine energy
        for (int i = start; i < end; i++) {
            if (a.ebits[i] <= 0) continue;
            for (int c = 0; c < C; c++) {
                int q2 = (int)dec.dec_bits(a.ebits[i]);
                float offset = (float)((q2 + 0.5)
                                       * (1 << (14 - a.ebits[i]))
                                       / 16384.0 - 0.5);
                old_ebands[i + c * nb] += offset;
            }
        }
        // band shapes
        std::memset(X, 0, (size_t)C * N * sizeof(double));
        int err = 0;
        int collapse_masks[50];
        uint32_t seed = *seed_io;
        {
            double* X_ = X;
            double* Y_ = C == 2 ? X + N : nullptr;
            int B = short_blocks ? M : 1;
            int norm_offset = M * eb[start];
            int norm_len = M * eb[nb - 1] - norm_offset;
            double norm_store[2 * 800];
            std::memset(norm_store, 0, sizeof(norm_store));
            double* norm = norm_store;
            double* norm2 = norm_store + norm_len;
            double scratch_store[256];
            double* lowband_scratch_store = scratch_store;
            std::memset(collapse_masks, 0, sizeof(collapse_masks));
            int64_t total_q = (int64_t)storage * (8 << BITRES)
                              - anti_collapse_rsv;
            int64_t balance = a.balance;
            int dual_stereo = a.dual_stereo;
            int lowband_offset = 0;
            bool update_lowband = true;
            BandCtx ctx;
            ctx.mode = &m;
            ctx.intensity = a.intensity;
            ctx.spread = spread;
            ctx.dec = &dec;
            ctx.seed = seed;
            ctx.disable_inv = 0;
            for (int i = start; i < end; i++) {
                ctx.i = i;
                bool last = i == end - 1;
                double* Xb = X_ + M * eb[i];
                double* Yb = Y_ ? Y_ + M * eb[i] : nullptr;
                int Nb = M * eb[i + 1] - M * eb[i];
                int64_t tell_q = dec.tell_frac();
                if (i != start) balance -= tell_q;
                int64_t remaining_bits = total_q - tell_q - 1;
                ctx.remaining_bits = remaining_bits;
                int b;
                if (i <= a.coded_bands - 1) {
                    int64_t curr_balance =
                        cdiv((int)balance,
                             a.coded_bands - i < 3 ? a.coded_bands - i
                                                   : 3);
                    int64_t v = a.pulses[i] + curr_balance;
                    if (remaining_bits + 1 < v) v = remaining_bits + 1;
                    if (v > 16383) v = 16383;
                    if (v < 0) v = 0;
                    b = (int)v;
                } else {
                    b = 0;
                }
                if ((M * eb[i] - Nb >= M * eb[start] || i == start + 1)
                    && (update_lowband || lowband_offset == 0))
                    lowband_offset = i;
                if (i == start + 1) {
                    // special_hybrid_folding
                    int n1 = M * (eb[start + 1] - eb[start]);
                    int n2 = M * (eb[start + 2] - eb[start + 1]);
                    for (int j = n1; j < n2; j++)
                        norm[j] = norm[j + n1 - n2];
                    if (dual_stereo)
                        for (int j = n1; j < n2; j++)
                            norm2[j] = norm2[j + n1 - n2];
                }
                ctx.tf_change = tf_res[i];
                double* lowband_scratch = lowband_scratch_store;
                if (i >= m.eff_ebands) {
                    Xb = norm;
                    if (Y_) Yb = norm;
                    lowband_scratch = nullptr;
                }
                if (last) lowband_scratch = nullptr;
                int effective_lowband = -1;
                int x_cm, y_cm;
                int Cc = C;
                if (lowband_offset != 0
                    && (spread != SPREAD_AGGRESSIVE || B > 1
                        || tf_res[i] < 0)) {
                    effective_lowband =
                        M * eb[lowband_offset] - norm_offset - Nb;
                    if (effective_lowband < 0) effective_lowband = 0;
                    int fold_start = lowband_offset;
                    while (true) {
                        fold_start -= 1;
                        if (M * eb[fold_start]
                            <= effective_lowband + norm_offset)
                            break;
                    }
                    int fold_end = lowband_offset - 1;
                    while (true) {
                        fold_end += 1;
                        if (!(fold_end < i
                              && M * eb[fold_end]
                                 < effective_lowband + norm_offset + Nb))
                            break;
                    }
                    x_cm = 0;
                    y_cm = 0;
                    int fold_i = fold_start;
                    while (true) {
                        x_cm |= collapse_masks[fold_i * Cc + 0];
                        y_cm |= collapse_masks[fold_i * Cc + Cc - 1];
                        fold_i += 1;
                        if (fold_i >= fold_end) break;
                    }
                } else {
                    x_cm = (1 << B) - 1;
                    y_cm = (1 << B) - 1;
                }
                if (dual_stereo && i == a.intensity) {
                    dual_stereo = 0;
                    int lim = M * eb[i] - norm_offset;
                    for (int j = 0; j < lim; j++)
                        norm[j] = 0.5 * (norm[j] + norm2[j]);
                }
                if (dual_stereo) {
                    double* lb = effective_lowband != -1
                                 ? norm + effective_lowband : nullptr;
                    double* lb2 = effective_lowband != -1
                                  ? norm2 + effective_lowband : nullptr;
                    double* lo = last ? nullptr
                                      : norm + (M * eb[i] - norm_offset);
                    double* lo2 = last ? nullptr
                                       : norm2 + (M * eb[i] - norm_offset);
                    x_cm = quant_band(ctx, Xb, Nb, b / 2, B, lb, LM, lo,
                                      1.0, lowband_scratch, x_cm, &err);
                    y_cm = quant_band(ctx, Yb, Nb, b / 2, B, lb2, LM, lo2,
                                      1.0, lowband_scratch, y_cm, &err);
                } else {
                    double* lb = effective_lowband != -1
                                 ? norm + effective_lowband : nullptr;
                    double* lo = last ? nullptr
                                      : norm + (M * eb[i] - norm_offset);
                    if (Yb) {
                        x_cm = quant_band_stereo(ctx, Xb, Yb, Nb, b, B,
                                                 lb, LM, lo,
                                                 lowband_scratch,
                                                 x_cm | y_cm, &err);
                    } else {
                        x_cm = quant_band(ctx, Xb, Nb, b, B, lb, LM, lo,
                                          1.0, lowband_scratch,
                                          x_cm | y_cm, &err);
                    }
                    y_cm = x_cm;
                }
                collapse_masks[i * Cc + 0] = x_cm;
                collapse_masks[i * Cc + Cc - 1] = y_cm;
                balance += a.pulses[i] + tell_q;
                update_lowband = b > (Nb << BITRES);
                if (err) return 2;
            }
            seed = ctx.seed;
        }
        int anti_collapse_on = 0;
        if (anti_collapse_rsv > 0) anti_collapse_on = (int)dec.dec_bits(1);
        // energy finalise
        {
            int bits_left = storage * 8 - dec.tell();
            for (int prio = 0; prio < 2; prio++) {
                int i = start;
                while (i < end && bits_left >= C) {
                    if (a.ebits[i] >= MAX_FINE_BITS
                        || a.fine_priority[i] != prio) {
                        i += 1;
                        continue;
                    }
                    for (int c = 0; c < C; c++) {
                        int q2 = (int)dec.dec_bits(1);
                        float offset = (float)(
                            (q2 - 0.5) * (1 << (14 - a.ebits[i] - 1))
                            / 16384.0);
                        old_ebands[i + c * nb] += offset;
                        bits_left -= 1;
                    }
                    i += 1;
                }
            }
        }
        if (anti_collapse_on) {
            // celt.py _anti_collapse; float32 promotion quirks of the
            // numpy path are mirrored with float intermediates
            for (int i = start; i < end; i++) {
                int N0b = eb[i + 1] - eb[i];
                int depth = ((1 + a.pulses[i]) / N0b) >> LM;
                double thresh = 0.5 * std::exp2(-0.125 * depth);
                double sqrt_1 = 1.0 / std::sqrt((double)(N0b << LM));
                for (int c = 0; c < C; c++) {
                    float prev1 = old_logE[c * nb + i];
                    float prev2 = old_logE2[c * nb + i];
                    if (C == 1) {
                        if (old_logE[nb + i] > prev1)
                            prev1 = old_logE[nb + i];
                        if (old_logE2[nb + i] > prev2)
                            prev2 = old_logE2[nb + i];
                    }
                    float mn = prev1 < prev2 ? prev1 : prev2;
                    float ediff = old_ebands[c * nb + i] - mn;
                    if (ediff < 0.0f) ediff = 0.0f;
                    float r = 2.0f * std::exp2(-ediff);
                    if (LM == 3) r *= 1.41421356f;
                    double rd = r < thresh ? (double)r : thresh;
                    rd *= sqrt_1;
                    double* Xb = X + c * N + (eb[i] << LM);
                    bool renorm = false;
                    for (int k = 0; k < (1 << LM); k++) {
                        if (!(collapse_masks[i * C + c] & (1 << k))) {
                            for (int j = 0; j < N0b; j++) {
                                seed = lcg(seed);
                                Xb[(j << LM) + k] =
                                    (seed & 0x8000) ? rd : -rd;
                            }
                            renorm = true;
                        }
                    }
                    if (renorm) {
                        int nband = N0b << LM;
                        double e = 0.0;
                        for (int j = 0; j < nband; j++)
                            e += Xb[j] * Xb[j];
                        e += 1e-15;
                        double g = 1.0 / std::sqrt(e);
                        for (int j = 0; j < nband; j++) Xb[j] *= g;
                    }
                }
            }
        }
        if (silence)
            for (int k = 0; k < 2 * nb; k++) old_ebands[k] = -28.0f;
        *seed_io = seed;
        flags_out[0] = silence;
        flags_out[1] = is_transient;
        flags_out[2] = pf_pitch;
        flags_out[3] = pf_tapset;
        flags_out[4] = anti_collapse_on;
        pf_gain_out[0] = pf_gain;
    }
    // write back range state (final rng is the next frame's noise seed)
    st64[1] = dec.offs;
    st64[2] = dec.end_offs;
    st64[3] = (int64_t)dec.end_window;
    st64[4] = dec.nend_bits;
    st64[5] = dec.nbits_total;
    st64[6] = dec.rng;
    st64[7] = dec.rem;
    st64[8] = dec.val;
    st64[9] = dec.error;
    return 0;
}

// ---- synthesis scalar helpers (celt.py _comb_filter / deemphasis) ------

extern "C" void celt_deemphasis(const double* x, double* pcm, int n,
                                double coef0, double* mem) {
    double m = mem[0];
    for (int j = 0; j < n; j++) {
        double tmp = x[j] + m;
        m = coef0 * tmp;
        pcm[j] = tmp;
    }
    mem[0] = m;
}

extern "C" void celt_comb_filter(double* x, int off, int T0, int T1,
                                 int n, double g0, double g1, int tapset0,
                                 int tapset1, const double* window,
                                 int overlap) {
    static const double COMB_GAINS[3][3] = {
        {0.3066406250, 0.2170410156, 0.1296386719},
        {0.4638671875, 0.2680664062, 0.0},
        {0.7998046875, 0.1000976562, 0.0}};
    constexpr int MINPERIOD = 15;
    if (g0 == 0.0 && g1 == 0.0) return;
    if (T0 < MINPERIOD) T0 = MINPERIOD;
    if (T1 < MINPERIOD) T1 = MINPERIOD;
    double g00 = g0 * COMB_GAINS[tapset0][0];
    double g01 = g0 * COMB_GAINS[tapset0][1];
    double g02 = g0 * COMB_GAINS[tapset0][2];
    double g10 = g1 * COMB_GAINS[tapset1][0];
    double g11 = g1 * COMB_GAINS[tapset1][1];
    double g12 = g1 * COMB_GAINS[tapset1][2];
    int ov = overlap;
    if (g0 == g1 && T0 == T1 && tapset0 == tapset1) ov = 0;
    if (ov > n) ov = n;
    double x1 = x[off - T1 + 1];
    double x2 = x[off - T1];
    double x3 = x[off - T1 - 1];
    double x4 = x[off - T1 - 2];
    for (int i = 0; i < ov; i++) {
        double x0 = x[off + i - T1 + 2];
        double f = window[i] * window[i];
        double v = x[off + i];
        v = v + (1 - f) * g00 * x[off + i - T0];
        v = v + (1 - f) * g01 * (x[off + i - T0 + 1]
                                 + x[off + i - T0 - 1]);
        v = v + (1 - f) * g02 * (x[off + i - T0 + 2]
                                 + x[off + i - T0 - 2]);
        v = v + f * g10 * x2;
        v = v + f * g11 * (x1 + x3);
        v = v + f * g12 * (x0 + x4);
        x[off + i] = v;
        x4 = x3;
        x3 = x2;
        x2 = x1;
        x1 = x0;
    }
    if (g1 == 0.0) return;
    // in-place tail: reads at lag T1 see already-filtered samples, same
    // as the Python path's lag-bounded chunks
    for (int i = off + ov; i < off + n; i++) {
        double v = x[i] + g10 * x[i - T1];
        v = v + g11 * (x[i - T1 + 1] + x[i - T1 - 1]);
        v = v + g12 * (x[i - T1 + 2] + x[i - T1 - 2]);
        x[i] = v;
    }
}
