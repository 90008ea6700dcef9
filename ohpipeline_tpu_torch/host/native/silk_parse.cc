// Native SILK LP-layer bitstream parser (RFC 6716 section 4.2).
//
// This is the C++ twin of the Python parse layer in
// codecs/opus/silk.py (parse_silk_packet / parse_silk_packet_stereo):
// the whole per-packet symbol schedule — header flags, LBRR flags and
// frames, stereo predictors, frame indices and the shell-coded
// excitation — runs through a native range decoder in one call, with
// the decoder state handed back for the hybrid-mode CELT handoff.
// Behaviour target: opus-1.5.2 silk/dec_API.c, decode_indices.c,
// decode_pulses.c, shell_coder.c, code_signs.c (consumed by the
// reference's OpenHome/Media/Codec/Opus.cpp); the Python layer is the
// behaviour oracle (OHP_SILK_PY=1 forces it) and tests assert exact
// agreement.
//
// Tables arrive as one uint8 blob + int32 offsets built by
// codecs/opus/silk.py:_parse_blob() from silk_tables.npz; the enum
// order here must match that builder.

#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------- range
// decoder (entdec.c reformulation; same state layout as celt_core.cc RD
// and codecs/opus/range_dec.py — the st64[10] handoff is shared)

constexpr int SYM_BITS = 8;
constexpr int CODE_BITS = 32;
constexpr uint32_t SYM_MAX = (1u << SYM_BITS) - 1;
constexpr uint32_t CODE_TOP = 1u << (CODE_BITS - 1);
constexpr uint32_t CODE_BOT = CODE_TOP >> SYM_BITS;
constexpr int CODE_EXTRA = (CODE_BITS - 2) % SYM_BITS + 1;
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

    int read_byte() { return offs < storage ? buf[offs++] : 0; }
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
    int dec_icdf(const uint8_t* icdf, int ftb) {
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
};

// ------------------------------------------------------------- tables
// enum order == codecs/opus/silk.py _parse_blob()

enum Tab {
    T_TYPE_VAD = 0,
    T_TYPE_NO_VAD,
    T_GAIN,                // 3 x 8 rows by signal type
    T_UNIFORM8,
    T_DELTA_GAIN,
    T_NLSF_CB1_NB_MB,      // 2 x 32 rows by (signal_type >> 1)
    T_NLSF_CB1_WB,
    T_NLSF_CB2_SEL_NB_MB,
    T_NLSF_CB2_SEL_WB,
    T_NLSF_CB2_NB_MB,      // 8 x 9 rows indexed by ec_ix
    T_NLSF_CB2_WB,
    T_NLSF_EXT,
    T_NLSF_INTERP,
    T_PITCH_DELTA,
    T_PITCH_LAG,
    T_UNIFORM4,
    T_UNIFORM6,
    T_CONTOUR_NB,
    T_CONTOUR,
    T_CONTOUR_10MS_NB,
    T_CONTOUR_10MS,
    T_LTP_PER,
    T_LTP_GAIN0,
    T_LTP_GAIN1,
    T_LTP_GAIN2,
    T_LTP_SCALE,
    T_RATE_LEVELS,         // 2 x 9 rows
    T_PULSES_PER_BLOCK,    // 10 x 18 rows
    T_SHELL0,              // shell_code_table0..3
    T_SHELL1,
    T_SHELL2,
    T_SHELL3,
    T_SHELL_OFFS,          // 17 offsets (values, not an iCDF)
    T_LSB,
    T_SIGN,                // 42 entries (values icdf0 per class)
    T_LBRR2,
    T_LBRR3,
    T_STEREO_JOINT,
    T_UNIFORM3,
    T_UNIFORM5,
    T_STEREO_MID_ONLY,
    T_COUNT
};

struct Tabs {
    const uint8_t* blob;
    const int32_t* offs;
    const uint8_t* get(int t) const { return blob + offs[t]; }
};

// ------------------------------------------------------------- frame row
// layout (int32, width IXW) == codecs/opus/silk.py native unpack

constexpr int IXW = 40;
enum IxField {
    IX_VALID = 0,
    IX_VAD = 1,
    IX_SIG = 2,
    IX_QOFF = 3,
    IX_GAIN0 = 4,          // ..7
    IX_NLSF1 = 8,
    IX_NLSF_RES0 = 9,      // ..24
    IX_INTERP = 25,
    IX_LAG = 26,
    IX_CONTOUR = 27,
    IX_PER = 28,
    IX_LTP0 = 29,          // ..32
    IX_LTP_SCALE = 33,
    IX_SEED = 34,
    IX_COND = 35,
};

constexpr int MAX_PULSES = 16;
constexpr int SHELL_FRAME = 16;

struct PrevState {
    int sig = -1;          // ec_prevSignalType (-1 = unset)
    int lag = 0;           // ec_prevLagIndex
};

struct BwParams {
    int fs_khz;
    int lpc_order;
    int low_bits_tab;      // uniform4/6/8 per bandwidth
};

BwParams bw_params(int bw) {
    if (bw == 0) return {8, 10, T_UNIFORM4};
    if (bw == 1) return {12, 10, T_UNIFORM6};
    return {16, 16, T_UNIFORM8};
}

// decode_indices.c for one frame; fills row[IXW]
void decode_frame_indices(RD& dec, const Tabs& T, int bw, int vad,
                          int n_subfr, int cond_coding, PrevState& prev,
                          int ltp_scale_decoded, int32_t* row) {
    BwParams p = bw_params(bw);
    for (int i = 0; i < IXW; i++) row[i] = 0;
    row[IX_VALID] = 1;
    row[IX_VAD] = vad;
    row[IX_COND] = cond_coding;
    int v;
    if (vad)
        v = dec.dec_icdf(T.get(T_TYPE_VAD), 8) + 2;
    else
        v = dec.dec_icdf(T.get(T_TYPE_NO_VAD), 8);
    int sig = v >> 1;
    row[IX_SIG] = sig;
    row[IX_QOFF] = v & 1;
    // gains
    if (cond_coding) {
        row[IX_GAIN0] = dec.dec_icdf(T.get(T_DELTA_GAIN), 8);
    } else {
        int msb = dec.dec_icdf(T.get(T_GAIN) + sig * 8, 8);
        int lsb = dec.dec_icdf(T.get(T_UNIFORM8), 8);
        row[IX_GAIN0] = (msb << 3) + lsb;
    }
    for (int k = 1; k < n_subfr; k++)
        row[IX_GAIN0 + k] = dec.dec_icdf(T.get(T_DELTA_GAIN), 8);
    // NLSF stage 1 + stage 2 residuals
    const uint8_t* cb1 = T.get(bw == 2 ? T_NLSF_CB1_WB : T_NLSF_CB1_NB_MB);
    int stage1 = dec.dec_icdf(cb1 + (sig >> 1) * 32, 8);
    row[IX_NLSF1] = stage1;
    const uint8_t* sel =
        T.get(bw == 2 ? T_NLSF_CB2_SEL_WB : T_NLSF_CB2_SEL_NB_MB);
    const uint8_t* cb2 =
        T.get(bw == 2 ? T_NLSF_CB2_WB : T_NLSF_CB2_NB_MB);
    const uint8_t* entries = sel + stage1 * (p.lpc_order / 2);
    for (int i = 0; i < p.lpc_order; i += 2) {
        int entry = entries[i / 2];
        int e0 = ((entry >> 1) & 7) * 9;
        int e1 = ((entry >> 5) & 7) * 9;
        for (int half = 0; half < 2; half++) {
            int vv = dec.dec_icdf(cb2 + (half ? e1 : e0), 8);
            if (vv == 0)
                vv -= dec.dec_icdf(T.get(T_NLSF_EXT), 8);
            else if (vv == 8)
                vv += dec.dec_icdf(T.get(T_NLSF_EXT), 8);
            row[IX_NLSF_RES0 + i + half] = vv - 4;
        }
    }
    row[IX_INTERP] = 4;
    if (n_subfr == 4)
        row[IX_INTERP] = dec.dec_icdf(T.get(T_NLSF_INTERP), 8);
    if (sig == 2) {        // voiced
        int decode_absolute = 1;
        int lag_index = 0;
        if (cond_coding && prev.sig == 2) {
            int delta = dec.dec_icdf(T.get(T_PITCH_DELTA), 8);
            if (delta > 0) {
                lag_index = prev.lag + (delta - 9);
                decode_absolute = 0;
            }
        }
        if (decode_absolute) {
            int high = dec.dec_icdf(T.get(T_PITCH_LAG), 8);
            int low = dec.dec_icdf(T.get(p.low_bits_tab), 8);
            lag_index = high * (p.fs_khz / 2) + low;
        }
        row[IX_LAG] = lag_index;
        prev.lag = lag_index;
        int contour_tab;
        if (n_subfr == 4)
            contour_tab = bw == 0 ? T_CONTOUR_NB : T_CONTOUR;
        else
            contour_tab = bw == 0 ? T_CONTOUR_10MS_NB : T_CONTOUR_10MS;
        row[IX_CONTOUR] = dec.dec_icdf(T.get(contour_tab), 8);
        int per = dec.dec_icdf(T.get(T_LTP_PER), 8);
        row[IX_PER] = per;
        const uint8_t* ltp_cb = T.get(T_LTP_GAIN0 + per);
        for (int k = 0; k < n_subfr; k++)
            row[IX_LTP0 + k] = dec.dec_icdf(ltp_cb, 8);
        if (ltp_scale_decoded)
            row[IX_LTP_SCALE] = dec.dec_icdf(T.get(T_LTP_SCALE), 8);
    }
    prev.sig = sig;
    row[IX_SEED] = dec.dec_icdf(T.get(T_UNIFORM4), 8);
}

// shell_coder.c silk_shell_decoder: split 16 -> ... -> 1.  The split
// symbols are decoded depth-first (left subtree fully before right),
// matching the reference recursion — decode order matters.
void shell_recurse(RD& dec, const Tabs& T, const uint8_t* offs,
                   const uint8_t* const shells[4], int p, int level,
                   int16_t* out) {
    if (level < 0) {
        *out = (int16_t)p;
        return;
    }
    int c1 = 0;
    if (p > 0) c1 = dec.dec_icdf(shells[level] + offs[p], 8);
    int half = 1 << level;
    shell_recurse(dec, T, offs, shells, c1, level - 1, out);
    shell_recurse(dec, T, offs, shells, p - c1, level - 1, out + half);
}

void shell_decode(RD& dec, const Tabs& T, int total, int16_t* out) {
    const uint8_t* offs = T.get(T_SHELL_OFFS);
    const uint8_t* shells[4] = {T.get(T_SHELL0), T.get(T_SHELL1),
                                T.get(T_SHELL2), T.get(T_SHELL3)};
    shell_recurse(dec, T, offs, shells, total, 3, out);
}

// decode_pulses.c + code_signs.c
void decode_excitation(RD& dec, const Tabs& T, int signal_type,
                       int quant_offset, int frame_length,
                       int16_t* pulses_out) {
    const uint8_t* rate_tab = T.get(T_RATE_LEVELS) + (signal_type >> 1) * 9;
    int rate_level = dec.dec_icdf(rate_tab, 8);
    int niter = frame_length / SHELL_FRAME;
    if (niter * SHELL_FRAME < frame_length) {
        // 10 ms @ 12 kHz (MB): 120 samples round UP to 8 shell blocks;
        // the tail block's extras are decoded then discarded
        // (decode_pulses.c:57-61, code_signs.c:91)
        niter += 1;
    }
    int16_t padded[20 * SHELL_FRAME];
    int16_t* pulses = padded;
    const uint8_t* ppb = T.get(T_PULSES_PER_BLOCK);
    int sum_pulses[20];
    int n_lshifts[20];
    for (int i = 0; i < niter; i++) {
        int shifts = 0;
        int s = dec.dec_icdf(ppb + rate_level * 18, 8);
        while (s == MAX_PULSES + 1) {
            shifts += 1;
            const uint8_t* row = ppb + 9 * 18 + (shifts == 10 ? 1 : 0);
            s = dec.dec_icdf(row, 8);
        }
        sum_pulses[i] = s;
        n_lshifts[i] = shifts;
    }
    memset(pulses, 0, niter * SHELL_FRAME * sizeof(int16_t));
    for (int i = 0; i < niter; i++)
        if (sum_pulses[i] > 0)
            shell_decode(dec, T, sum_pulses[i],
                         pulses + i * SHELL_FRAME);
    for (int i = 0; i < niter; i++) {
        int shifts = n_lshifts[i];
        if (shifts > 0) {
            int16_t* blk = pulses + i * SHELL_FRAME;
            for (int k = 0; k < SHELL_FRAME; k++) {
                int q = blk[k];
                for (int j = 0; j < shifts; j++)
                    q = (q << 1) + dec.dec_icdf(T.get(T_LSB), 8);
                blk[k] = (int16_t)q;
            }
            sum_pulses[i] |= shifts << 5;
        }
    }
    // signs
    int sign_base = 7 * (quant_offset + (signal_type << 1));
    const uint8_t* sign_tab = T.get(T_SIGN);
    for (int i = 0; i < niter; i++) {
        int s = sum_pulses[i];
        if (s <= 0) continue;
        int cls = s & 0x1F;
        if (cls > 6) cls = 6;
        uint8_t icdf[2] = {sign_tab[sign_base + cls], 0};
        int16_t* blk = pulses + i * SHELL_FRAME;
        for (int k = 0; k < SHELL_FRAME; k++)
            if (blk[k] > 0 && dec.dec_icdf(icdf, 8) == 0)
                blk[k] = (int16_t)(-blk[k]);
    }
    memcpy(pulses_out, padded, frame_length * sizeof(int16_t));
}

// dec_API.c:238-250 per-frame LBRR flags (after the channel LBRR bit)
void decode_lbrr_flags(RD& dec, const Tabs& T, int n_frames, int lbrr_bit,
                       int* flags) {
    if (!lbrr_bit) {
        for (int i = 0; i < n_frames; i++) flags[i] = 0;
        return;
    }
    if (n_frames == 1) {
        flags[0] = 1;
        return;
    }
    const uint8_t* tab = T.get(n_frames == 2 ? T_LBRR2 : T_LBRR3);
    int sym = dec.dec_icdf(tab, 8) + 1;
    for (int i = 0; i < n_frames; i++) flags[i] = (sym >> i) & 1;
}

// stereo_decode_pred.c: predictor indices -> pred_Q13[2]
void stereo_decode_pred(RD& dec, const Tabs& T,
                        const int32_t* quant_q13, int32_t* pred) {
    int n = dec.dec_icdf(T.get(T_STEREO_JOINT), 8);
    int ix2[2] = {n / 5, n % 5};
    for (int ch = 0; ch < 2; ch++) {
        int i0 = dec.dec_icdf(T.get(T_UNIFORM3), 8);
        int i1 = dec.dec_icdf(T.get(T_UNIFORM5), 8);
        i0 += 3 * ix2[ch];
        int32_t low = quant_q13[i0];
        int32_t step =
            (int32_t)(((int64_t)(quant_q13[i0 + 1] - low) * 6554) >> 16);
        pred[ch] = low + step * (2 * i1 + 1);
    }
    pred[0] -= pred[1];
}

}  // namespace

extern "C" {

// Parse one SILK packet (mono or stereo layer) natively.
//
// st64: [0]!=0 -> resume the range decoder from [1..9]
//       (offs, end_offs, end_window, nend_bits, nbits_total, rng, rem,
//       val, error); always written back on return.
// out_ix / out_pulses: (n_frames * nch) rows (frame-major, mid before
// side), IXW int32s / frame_length int16s each.
// out_lbrr_ix / out_lbrr_pulses: same shape for the LBRR (FEC) frames;
// rows with IX_VALID==0 carry no LBRR data.
// out_stereo: per frame [pred0_q13, pred1_q13, mid_only] (stereo only).
// Returns 0 on success.
int silk_parse_packet(
    const uint8_t* data, int len, int64_t* st64, int bw, int stereo,
    int n_frames, int n_subfr, int frame_length,
    const uint8_t* tab_blob, const int32_t* tab_offs,
    const int32_t* pred_quant_q13,
    int32_t* out_ix, int16_t* out_pulses,
    int32_t* out_lbrr_ix, int16_t* out_lbrr_pulses,
    int32_t* out_stereo) {
    Tabs T{tab_blob, tab_offs};
    RD dec;
    if (st64[0]) {
        dec.buf = data;
        dec.storage = len;
        dec.ext = 0;
        dec.offs = (int)st64[1];
        dec.end_offs = (int)st64[2];
        dec.end_window = (uint64_t)st64[3];
        dec.nend_bits = (int)st64[4];
        dec.nbits_total = (int)st64[5];
        dec.rng = (uint32_t)st64[6];
        dec.rem = (int)st64[7];
        dec.val = (uint32_t)st64[8];
        dec.error = (int)st64[9];
    } else {
        dec.init(data, len);
    }
    int nch = stereo ? 2 : 1;
    for (int i = 0; i < n_frames * nch; i++) {
        out_ix[i * IXW + IX_VALID] = 0;
        out_lbrr_ix[i * IXW + IX_VALID] = 0;
    }

    int vad[2][3];
    int lbrr[2][3];
    if (!stereo) {
        for (int i = 0; i < n_frames; i++)
            vad[0][i] = dec.dec_bit_logp(1);
        int lbrr_bit = dec.dec_bit_logp(1);
        decode_lbrr_flags(dec, T, n_frames, lbrr_bit, lbrr[0]);
        PrevState prev_lbrr;
        for (int i = 0; i < n_frames; i++) {
            if (!lbrr[0][i]) continue;
            // LBRR frames always use the VAD-conditioned tables
            int cond = i > 0 && lbrr[0][i - 1];
            int32_t* row = out_lbrr_ix + i * IXW;
            decode_frame_indices(dec, T, bw, 1, n_subfr, cond, prev_lbrr,
                                 !cond, row);
            decode_excitation(dec, T, row[IX_SIG], row[IX_QOFF],
                              frame_length,
                              out_lbrr_pulses + i * frame_length);
        }
        PrevState prev;
        for (int i = 0; i < n_frames; i++) {
            int cond = i > 0;
            int32_t* row = out_ix + i * IXW;
            decode_frame_indices(dec, T, bw, vad[0][i], n_subfr, cond,
                                 prev, !cond, row);
            decode_excitation(dec, T, row[IX_SIG], row[IX_QOFF],
                              frame_length,
                              out_pulses + i * frame_length);
        }
    } else {
        int lbrr_bit[2];
        for (int ch = 0; ch < 2; ch++) {
            for (int i = 0; i < n_frames; i++)
                vad[ch][i] = dec.dec_bit_logp(1);
            lbrr_bit[ch] = dec.dec_bit_logp(1);
        }
        for (int ch = 0; ch < 2; ch++)
            decode_lbrr_flags(dec, T, n_frames, lbrr_bit[ch], lbrr[ch]);
        PrevState prev_lbrr[2];
        for (int i = 0; i < n_frames; i++) {
            for (int ch = 0; ch < 2; ch++) {
                if (!lbrr[ch][i]) continue;
                if (ch == 0) {
                    int32_t dummy_pred[2];
                    stereo_decode_pred(dec, T, pred_quant_q13, dummy_pred);
                    if (lbrr[1][i] == 0)
                        dec.dec_icdf(T.get(T_STEREO_MID_ONLY), 8);
                }
                int cond = i > 0 && lbrr[ch][i - 1];
                int32_t* row = out_lbrr_ix + (i * 2 + ch) * IXW;
                decode_frame_indices(dec, T, bw, 1, n_subfr, cond,
                                     prev_lbrr[ch], !cond, row);
                decode_excitation(
                    dec, T, row[IX_SIG], row[IX_QOFF], frame_length,
                    out_lbrr_pulses + (i * 2 + ch) * frame_length);
            }
        }
        PrevState prev[2];
        int prev_mid_only = -1;
        for (int i = 0; i < n_frames; i++) {
            int32_t pred[2];
            stereo_decode_pred(dec, T, pred_quant_q13, pred);
            int mid_only = 0;
            if (!vad[1][i])
                mid_only = dec.dec_icdf(T.get(T_STEREO_MID_ONLY), 8);
            int32_t* row_m = out_ix + (i * 2) * IXW;
            decode_frame_indices(dec, T, bw, vad[0][i], n_subfr, i > 0,
                                 prev[0], !(i > 0), row_m);
            decode_excitation(dec, T, row_m[IX_SIG], row_m[IX_QOFF],
                              frame_length,
                              out_pulses + (i * 2) * frame_length);
            if (!mid_only) {
                // side frame: frame 0 independent (with LTP scale);
                // after a mid-only frame independent without one;
                // otherwise conditional (dec_API.c:344-372)
                int cond, ltp_dec;
                if (i == 0) {
                    cond = 0;
                    ltp_dec = 1;
                } else if (prev_mid_only) {
                    cond = 0;
                    ltp_dec = 0;
                } else {
                    cond = 1;
                    ltp_dec = 0;
                }
                int32_t* row_s = out_ix + (i * 2 + 1) * IXW;
                decode_frame_indices(dec, T, bw, vad[1][i], n_subfr, cond,
                                     prev[1], ltp_dec, row_s);
                decode_excitation(
                    dec, T, row_s[IX_SIG], row_s[IX_QOFF], frame_length,
                    out_pulses + (i * 2 + 1) * frame_length);
            }
            prev_mid_only = mid_only;
            out_stereo[i * 3] = pred[0];
            out_stereo[i * 3 + 1] = pred[1];
            out_stereo[i * 3 + 2] = mid_only;
        }
    }
    st64[0] = 1;
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

}  // extern "C"
