// Fused SILK frame dequantisation + synthesis.
//
// C++ twin of the per-frame Python orchestration in
// codecs/opus/silk.py (_synthesise_fix): gains dequant
// (silk/gain_quant.c), NLSF dequant + stabilise (silk/NLSF_decode.c,
// NLSF_stabilize.c), NLSF->LPC (silk_nlsf2a in silk_core.cc), pitch
// lag + LTP tap dequant (silk/decode_pitch.c, decode_parameters.c),
// then one call into the existing silk_frame_fix core.  Input is the
// raw 40-int32 frame-index row that silk_parse.cc produces, so a whole
// frame decodes with a single native call.  The Python functions
// remain the behaviour oracle (OHP_SILK_PY forces them).
//
// Tables arrive as one int32 blob + offsets built by
// codecs/opus/silk.py:_dq_blob() from silk_tables.npz; the enum order
// here must match that builder.

#include <cstdint>
#include <cstring>

extern "C" int silk_frame_fix(
    int lost, const int16_t* pulses, int frame_length, int subfr_length,
    int nb_subfr, int lpc_order, int ltp_mem_length,
    const int16_t* A_Q12_both, const int16_t* B_Q14_all,
    const int32_t* Gains_Q16, const int32_t* pitchL, int LTP_scale_Q14,
    int signalTypeInd, int quantOffsetType, int32_t seed,
    int nlsf_interp_flag, const int16_t* prevNLSF_Q15,
    const int16_t* cos_tab, int fs_khz,
    int16_t* outBuf, int32_t* sLPC_Q14_buf, int32_t* prev_gain_Q16,
    int32_t* exc_Q14_state, int32_t* plc_i32, int16_t* plc_i16,
    int32_t* cng_i32, int16_t* cng_i16, int32_t* misc, int16_t* xq);

extern "C" void silk_nlsf2a(const int16_t* nlsf_q15, int d,
                            const int16_t* cos_tab_q12, int16_t* a_q12);

namespace {

// ---- table blob (order == silk.py _dq_blob) -------------------------
enum DqTab {
    D_SEL_NB_MB = 0,
    D_SEL_WB,
    D_PRED_NB_MB_Q8,
    D_PRED_WB_Q8,
    D_CB1_NB_MB_Q8,
    D_CB1_WB_Q8,
    D_CB1_WGHT_NB_MB_Q9,
    D_CB1_WGHT_WB_Q9,
    D_DMIN_NB_MB_Q15,
    D_DMIN_WB_Q15,
    D_LAGS_S2,           // 4 x 11
    D_LAGS_S3,           // 4 x 34
    D_LAGS_S2_10,        // 2 x 3
    D_LAGS_S3_10,        // 2 x 12
    D_LTP_VQ0,           // 8 x 5
    D_LTP_VQ1,           // 16 x 5
    D_LTP_VQ2,           // 32 x 5
    D_LTP_SCALES,        // 3
    D_COUNT
};

// frame-row layout == silk_parse.cc IxField
enum IxField {
    IX_SIG = 2,
    IX_QOFF = 3,
    IX_GAIN0 = 4,
    IX_NLSF1 = 8,
    IX_NLSF_RES0 = 9,
    IX_INTERP = 25,
    IX_LAG = 26,
    IX_CONTOUR = 27,
    IX_PER = 28,
    IX_LTP0 = 29,
    IX_LTP_SCALE = 33,
    IX_SEED = 34,
    IX_COND = 35,
};

// ---- silk_log2lin (silk/log2lin.c) ---------------------------------
int32_t log2lin(int32_t x_q7) {
    if (x_q7 < 0) return 0;
    if (x_q7 > 3967) x_q7 = 3967;
    int32_t out = 1 << (x_q7 >> 7);
    int32_t frac = x_q7 & 0x7F;
    int32_t para =
        frac + (int32_t)(((int64_t)frac * (128 - frac) * -174) >> 16);
    if (x_q7 < 2048)
        out = out + (int32_t)(((int64_t)out * para) >> 7);
    else
        out = out + (out >> 7) * para;
    return out;
}

// ---- silk_gains_dequant (silk/gain_quant.c) ------------------------
constexpr int N_LEVELS_QGAIN = 64;
constexpr int MIN_DELTA_GAIN = -4;
constexpr int MAX_DELTA_GAIN = 36;
constexpr int GAIN_OFFSET = (2 * 128) / 6 + 16 * 128;
constexpr int64_t INV_SCALE_Q16 =
    (65536LL * (((88 - 2) * 128) / 6)) / (N_LEVELS_QGAIN - 1);

void gains_dequant(const int32_t* ind, int n, int conditional,
                   int32_t* prev_ind, int32_t* out_q16) {
    int pi = *prev_ind;
    for (int k = 0; k < n; k++) {
        if (k == 0 && !conditional) {
            pi = ind[k] > pi - 16 ? ind[k] : pi - 16;
        } else {
            int ind_tmp = (int)ind[k] + MIN_DELTA_GAIN;
            int thr = 2 * MAX_DELTA_GAIN - N_LEVELS_QGAIN + pi;
            if (ind_tmp > thr)
                pi += (ind_tmp << 1) - thr;
            else
                pi += ind_tmp;
        }
        if (pi < 0) pi = 0;
        if (pi > N_LEVELS_QGAIN - 1) pi = N_LEVELS_QGAIN - 1;
        int32_t log_q7 =
            (int32_t)((INV_SCALE_Q16 * pi) >> 16) + GAIN_OFFSET;
        if (log_q7 > 3967) log_q7 = 3967;
        out_q16[k] = log2lin(log_q7);
    }
    *prev_ind = pi;
}

// ---- silk_NLSF_decode + stabilise (NLSF_decode.c, NLSF_stabilize.c)
void nlsf_decode(int bw, int stage1, const int32_t* residuals, int order,
                 const int32_t* dq, const int32_t* dqo, int16_t* nlsf_out) {
    const int32_t* sel = dq + dqo[bw == 2 ? D_SEL_WB : D_SEL_NB_MB];
    const int32_t* pred_tab =
        dq + dqo[bw == 2 ? D_PRED_WB_Q8 : D_PRED_NB_MB_Q8];
    const int32_t* cb1 = dq + dqo[bw == 2 ? D_CB1_WB_Q8 : D_CB1_NB_MB_Q8];
    const int32_t* wght =
        dq + dqo[bw == 2 ? D_CB1_WGHT_WB_Q9 : D_CB1_WGHT_NB_MB_Q9];
    const int32_t* dmin =
        dq + dqo[bw == 2 ? D_DMIN_WB_Q15 : D_DMIN_NB_MB_Q15];
    int step = bw == 2 ? 9830 : 11796;        // 0.15 / 0.18 in Q16
    // backward predictors per residual
    int64_t pred[16];
    const int32_t* entries = sel + stage1 * (order / 2);
    for (int i = 0; i < order; i += 2) {
        int entry = (int)entries[i / 2];
        pred[i] = pred_tab[i + (entry & 1) * (order - 1)];
        pred[i + 1] = pred_tab[i + ((entry >> 4) & 1) * (order - 1) + 1];
    }
    // residual dequant, backwards
    int64_t res_q10[16];
    int64_t out_q10 = 0;
    for (int i = order - 1; i >= 0; i--) {
        int64_t pred_q10 = (out_q10 * pred[i]) >> 8;
        out_q10 = (int64_t)residuals[i] << 10;
        if (out_q10 > 0)
            out_q10 -= 102;                    // QUANT_LEVEL_ADJ in Q10
        else if (out_q10 < 0)
            out_q10 += 102;
        out_q10 = pred_q10 + ((out_q10 * step) >> 16);
        res_q10[i] = out_q10;
    }
    int64_t nlsf[16];
    for (int i = 0; i < order; i++) {
        int64_t num = res_q10[i] << 14;
        int64_t w = wght[stage1 * order + i];
        int64_t quot = num / w;                // C: truncates toward zero
        int64_t v = quot + ((int64_t)cb1[stage1 * order + i] << 7);
        if (v < 0) v = 0;
        if (v > 32767) v = 32767;
        nlsf[i] = v;
    }
    // stabilise: 20 damped iterations, then hard sort + clamp fallback
    for (int it = 0; it < 20; it++) {
        int64_t dm = nlsf[0] - dmin[0];
        int I = 0;
        for (int i = 1; i < order; i++) {
            int64_t d = nlsf[i] - (nlsf[i - 1] + dmin[i]);
            if (d < dm) {
                dm = d;
                I = i;
            }
        }
        int64_t dlast = 32768 - (nlsf[order - 1] + dmin[order]);
        if (dlast < dm) {
            dm = dlast;
            I = order;
        }
        if (dm >= 0) {
            for (int i = 0; i < order; i++) nlsf_out[i] = (int16_t)nlsf[i];
            return;
        }
        if (I == 0) {
            nlsf[0] = dmin[0];
        } else if (I == order) {
            nlsf[order - 1] = 32768 - dmin[order];
        } else {
            int64_t min_c = dmin[I] >> 1;
            for (int i = 0; i < I; i++) min_c += dmin[i];
            int64_t max_c = 32768 - (dmin[I] >> 1);
            for (int i = I + 1; i <= order; i++) max_c -= dmin[i];
            int64_t center = (nlsf[I - 1] + nlsf[I] + 1) >> 1;
            if (center < min_c) center = min_c;
            if (center > max_c) center = max_c;
            nlsf[I - 1] = center - (dmin[I] >> 1);
            nlsf[I] = nlsf[I - 1] + dmin[I];
        }
    }
    // fallback: insertion sort + forced spacing both directions
    for (int i = 1; i < order; i++) {
        int64_t v = nlsf[i];
        int j = i - 1;
        while (j >= 0 && nlsf[j] > v) {
            nlsf[j + 1] = nlsf[j];
            j--;
        }
        nlsf[j + 1] = v;
    }
    for (int i = 0; i < order; i++) {
        int64_t lo = i ? nlsf[i - 1] + dmin[i] : dmin[0];
        if (nlsf[i] < lo) nlsf[i] = lo;
    }
    for (int i = order - 1; i >= 0; i--) {
        int64_t hi =
            i < order - 1 ? nlsf[i + 1] - dmin[i + 1] : 32768 - dmin[order];
        if (nlsf[i] > hi) nlsf[i] = hi;
    }
    for (int i = 0; i < order; i++) nlsf_out[i] = (int16_t)nlsf[i];
}

}  // namespace

extern "C" {

// One parsed frame row -> PCM through the fixed-point core; returns
// silk_frame_fix's status.  prev_gain_ind / prev_nlsf / have_prev are
// the decoder's inter-frame dequant state (in/out).
int silk_synth_frame_fix(
    const int32_t* row, const int16_t* pulses, int bw, int nb_subfr,
    int subfr_length, int lpc_order, int ltp_mem_length, int fs_khz,
    const int32_t* dq, const int32_t* dqo, const int16_t* cos_tab,
    int32_t* prev_gain_ind, int16_t* prev_nlsf, int32_t* have_prev,
    int16_t* outBuf, int32_t* sLPC_Q14_buf, int32_t* prev_gain_Q16,
    int32_t* exc_Q14_state, int32_t* plc_i32, int16_t* plc_i16,
    int32_t* cng_i32, int16_t* cng_i16, int32_t* misc, int16_t* xq) {
    int frame_length = nb_subfr * subfr_length;
    int sig = (int)row[IX_SIG];
    // gains
    int32_t gains_q16[4];
    gains_dequant(row + IX_GAIN0, nb_subfr, (int)row[IX_COND],
                  prev_gain_ind, gains_q16);
    // NLSF -> LPC (with optional interpolated first half)
    int16_t nlsf[16];
    nlsf_decode(bw, (int)row[IX_NLSF1], row + IX_NLSF_RES0, lpc_order,
                dq, dqo, nlsf);
    int16_t a_both[2 * 16];
    memset(a_both, 0, sizeof(a_both));
    silk_nlsf2a(nlsf, lpc_order, cos_tab, &a_both[16]);
    int interp = row[IX_INTERP] < 4 && *have_prev;
    if (interp) {
        int16_t nlsf0[16];
        for (int i = 0; i < lpc_order; i++)
            nlsf0[i] = (int16_t)(prev_nlsf[i]
                                 + ((row[IX_INTERP]
                                     * ((int32_t)nlsf[i] - prev_nlsf[i]))
                                    >> 2));
        silk_nlsf2a(nlsf0, lpc_order, cos_tab, &a_both[0]);
    } else {
        memcpy(&a_both[0], &a_both[16], 16 * sizeof(int16_t));
    }
    memcpy(prev_nlsf, nlsf, lpc_order * sizeof(int16_t));
    *have_prev = 1;
    // pitch lags + LTP taps
    int32_t lags[4] = {0, 0, 0, 0};
    int16_t b_q14[4 * 5];
    memset(b_q14, 0, sizeof(b_q14));
    int ltp_scale = 0;
    if (sig == 2) {
        const int32_t* cb;
        int ncols;
        if (fs_khz == 8) {
            cb = dq + dqo[nb_subfr == 4 ? D_LAGS_S2 : D_LAGS_S2_10];
            ncols = nb_subfr == 4 ? 11 : 3;
        } else {
            cb = dq + dqo[nb_subfr == 4 ? D_LAGS_S3 : D_LAGS_S3_10];
            ncols = nb_subfr == 4 ? 34 : 12;
        }
        int min_lag = 2 * fs_khz, max_lag = 18 * fs_khz;
        int lag = min_lag + (int)row[IX_LAG];
        for (int k = 0; k < nb_subfr; k++) {
            int v = lag + (int)cb[k * ncols + row[IX_CONTOUR]];
            if (v < min_lag) v = min_lag;
            if (v > max_lag) v = max_lag;
            lags[k] = v;
        }
        const int32_t* vq = dq + dqo[D_LTP_VQ0 + row[IX_PER]];
        for (int k = 0; k < nb_subfr; k++)
            for (int j = 0; j < 5; j++)
                b_q14[k * 5 + j] =
                    (int16_t)(vq[row[IX_LTP0 + k] * 5 + j] << 7);
        ltp_scale = (int)(dq + dqo[D_LTP_SCALES])[row[IX_LTP_SCALE]];
    }
    return silk_frame_fix(
        0, pulses, frame_length, subfr_length, nb_subfr, lpc_order,
        ltp_mem_length, a_both, b_q14, gains_q16, lags, ltp_scale, sig,
        (int)row[IX_QOFF], row[IX_SEED], interp, nlsf, cos_tab, fs_khz,
        outBuf, sLPC_Q14_buf, prev_gain_Q16, exc_Q14_state, plc_i32,
        plc_i16, cng_i32, cng_i16, misc, xq);
}

}  // extern "C"
