// Fixed-point SILK synthesis core (host-side, called via ctypes).
//
// Bit-exact reimplementation of the normative SILK decoder arithmetic
// (RFC 6716 declares the reference implementation normative, so the
// Q-format operations and their ordering must match exactly):
//   * decode_core:      thirdparty/opus-1.5.2/silk/decode_core.c
//   * NLSF -> LPC:      silk/NLSF2A.c, silk/LPC_fit.c,
//                       silk/LPC_inv_pred_gain.c, silk/bwexpander_32.c
//   * rewhitening FIR:  silk/LPC_analysis_filter.c (generic C branch)
//   * output resampler: silk/resampler_private_up2_HQ.c,
//                       silk/resampler_private_IIR_FIR.c
//   * stereo unmix:     silk/stereo_MS_to_LR.c
//   * helpers:          silk/Inlines.h (INVERSE32_varQ / DIV32_varQ),
//                       silk/macros.h, silk/SigProc_FIX.h
// Data layouts and the batched call surface are this framework's own;
// the per-sample arithmetic follows the normative decoder.  The entropy
// layer and parameter dequantisation live in Python
// (ohpipeline_tpu/codecs/opus/silk.py); this file is the integer
// synthesis path that replaces the round-2 float reformulation.

#include <cstdint>
#include <cstring>

extern "C" void silk_nlsf2a(const int16_t* nlsf_q15, int d,
                            const int16_t* cos_tab_q12, int16_t* a_q12);

namespace {

inline int32_t SAT16(int32_t a) {
    return a > 32767 ? 32767 : (a < -32768 ? -32768 : a);
}
inline int32_t SMULWB(int32_t a, int32_t b) {
    return (int32_t)(((int64_t)a * (int16_t)b) >> 16);
}
inline int32_t SMLAWB(int32_t a, int32_t b, int32_t c) {
    return (int32_t)((uint32_t)a + (uint32_t)SMULWB(b, c));
}
inline int32_t SMULWW(int32_t a, int32_t b) {
    return (int32_t)(((int64_t)a * b) >> 16);
}
inline int32_t SMLAWW(int32_t a, int32_t b, int32_t c) {
    return (int32_t)((uint32_t)a + (uint32_t)SMULWW(b, c));
}
inline int32_t SMMUL(int32_t a, int32_t b) {
    return (int32_t)(((int64_t)a * b) >> 32);
}
inline int32_t SMULBB(int32_t a, int32_t b) {
    return (int32_t)(int16_t)a * (int32_t)(int16_t)b;
}
inline int32_t RSHIFT_ROUND(int32_t a, int s) {
    return s == 1 ? (a >> 1) + (a & 1) : ((a >> (s - 1)) + 1) >> 1;
}
inline int64_t RSHIFT_ROUND64(int64_t a, int s) {
    return s == 1 ? (a >> 1) + (a & 1) : ((a >> (s - 1)) + 1) >> 1;
}
inline int32_t ADD_SAT32(int32_t a, int32_t b) {
    int64_t r = (int64_t)a + b;
    return r > INT32_MAX ? INT32_MAX
                         : (r < INT32_MIN ? (int32_t)INT32_MIN : (int32_t)r);
}
inline int32_t SUB_SAT32(int32_t a, int32_t b) {
    int64_t r = (int64_t)a - b;
    return r > INT32_MAX ? INT32_MAX
                         : (r < INT32_MIN ? (int32_t)INT32_MIN : (int32_t)r);
}
inline int32_t LSHIFT_SAT32(int32_t a, int s) {
    int64_t r = (int64_t)a << s;
    return r > INT32_MAX ? INT32_MAX
                         : (r < INT32_MIN ? (int32_t)INT32_MIN : (int32_t)r);
}
inline int CLZ32(int32_t x) {
    return x == 0 ? 32 : __builtin_clz((uint32_t)x);
}
inline int32_t ABS32(int32_t a) { return a < 0 ? -a : a; }

// silk/Inlines.h:silk_INVERSE32_varQ — approximate (1 << Qres) / b32
int32_t INVERSE32_varQ(int32_t b32, int Qres) {
    int b_headrm = CLZ32(ABS32(b32)) - 1;
    int32_t b32_nrm = (int32_t)((uint32_t)b32 << b_headrm);
    int32_t b32_inv = (int32_t)((INT32_MAX >> 2) / (b32_nrm >> 16));
    int32_t result = (int32_t)((uint32_t)b32_inv << 16);
    int32_t err_Q32 =
        (int32_t)((uint32_t)(((int32_t)1 << 29) - SMULWB(b32_nrm, b32_inv))
                  << 3);
    result = SMLAWW(result, err_Q32, b32_inv);
    int lshift = 61 - b_headrm - Qres;
    if (lshift <= 0) return LSHIFT_SAT32(result, -lshift);
    return lshift < 32 ? (result >> lshift) : 0;
}

// silk/Inlines.h:silk_DIV32_varQ — approximate (a32 << Qres) / b32
int32_t DIV32_varQ(int32_t a32, int32_t b32, int Qres) {
    int a_headrm = CLZ32(ABS32(a32)) - 1;
    int32_t a32_nrm = (int32_t)((uint32_t)a32 << a_headrm);
    int b_headrm = CLZ32(ABS32(b32)) - 1;
    int32_t b32_nrm = (int32_t)((uint32_t)b32 << b_headrm);
    int32_t b32_inv = (int32_t)((INT32_MAX >> 2) / (b32_nrm >> 16));
    int32_t result = SMULWB(a32_nrm, b32_inv);
    a32_nrm = (int32_t)((uint32_t)a32_nrm -
                        ((uint32_t)SMMUL(b32_nrm, result) << 3));
    result = SMLAWB(result, a32_nrm, b32_inv);
    int lshift = 29 + a_headrm - b_headrm - Qres;
    if (lshift < 0) return LSHIFT_SAT32(result, -lshift);
    return lshift < 32 ? (result >> lshift) : 0;
}

// silk/bwexpander_32.c — chirp the AR coefficients toward the origin
void bwexpander_32(int32_t* ar, int d, int32_t chirp_Q16) {
    int32_t chirp_minus_one_Q16 = chirp_Q16 - 65536;
    for (int i = 0; i < d - 1; i++) {
        ar[i] = SMULWW(chirp_Q16, ar[i]);
        chirp_Q16 += RSHIFT_ROUND(
            (int32_t)((int64_t)chirp_Q16 * chirp_minus_one_Q16), 16);
    }
    ar[d - 1] = SMULWW(chirp_Q16, ar[d - 1]);
}

// silk/LPC_fit.c — saturate Q(QIN) coefficients into int16 Q(QOUT)
void LPC_fit(int16_t* a_QOUT, int32_t* a_QIN, int QOUT, int QIN, int d) {
    int i, k, idx = 0;
    for (i = 0; i < 10; i++) {
        int32_t maxabs = 0;
        for (k = 0; k < d; k++) {
            int32_t absval = ABS32(a_QIN[k]);
            if (absval > maxabs) {
                maxabs = absval;
                idx = k;
            }
        }
        maxabs = RSHIFT_ROUND(maxabs, QIN - QOUT);
        if (maxabs > 32767) {
            maxabs = maxabs < 163838 ? maxabs : 163838;
            int32_t chirp_Q16 =
                ((int32_t)(0.999 * 65536.0 + 0.5)) -
                (int32_t)(((int64_t)(maxabs - 32767) << 14) /
                          (((int64_t)maxabs * (idx + 1)) >> 2));
            bwexpander_32(a_QIN, d, chirp_Q16);
        } else {
            break;
        }
    }
    if (i == 10) {
        for (k = 0; k < d; k++) {
            a_QOUT[k] = (int16_t)SAT16(RSHIFT_ROUND(a_QIN[k], QIN - QOUT));
            a_QIN[k] = (int32_t)((uint32_t)a_QOUT[k] << (QIN - QOUT));
        }
    } else {
        for (k = 0; k < d; k++)
            a_QOUT[k] = (int16_t)RSHIFT_ROUND(a_QIN[k], QIN - QOUT);
    }
}

// silk/LPC_inv_pred_gain.c — Q30 inverse prediction gain; 0 == unstable
constexpr int kQA24 = 24;
constexpr int32_t kALimit = (int32_t)(0.99975 * (1 << kQA24) + 0.5);
constexpr int32_t kInvMaxPredGain =
    (int32_t)((1.0 / 1e4) * (1 << 30) + 0.5);  // 1/MAX_PREDICTION_POWER_GAIN

inline int32_t MUL32_FRAC_Q(int32_t a32, int32_t b32, int Q) {
    return (int32_t)RSHIFT_ROUND64((int64_t)a32 * b32, Q);
}

int32_t LPC_inverse_pred_gain_QA(int32_t* A_QA, int order) {
    int32_t invGain_Q30 = (int32_t)1 << 30;
    for (int k = order - 1; k > 0; k--) {
        if (A_QA[k] > kALimit || A_QA[k] < -kALimit) return 0;
        int32_t rc_Q31 = -(int32_t)((uint32_t)A_QA[k] << (31 - kQA24));
        int32_t rc_mult1_Q30 = ((int32_t)1 << 30) - SMMUL(rc_Q31, rc_Q31);
        invGain_Q30 =
            (int32_t)((uint32_t)SMMUL(invGain_Q30, rc_mult1_Q30) << 2);
        if (invGain_Q30 < kInvMaxPredGain) return 0;
        int mult2Q = 32 - CLZ32(ABS32(rc_mult1_Q30));
        int32_t rc_mult2 = INVERSE32_varQ(rc_mult1_Q30, mult2Q + 30);
        for (int n = 0; n < (k + 1) >> 1; n++) {
            int32_t tmp1 = A_QA[n];
            int32_t tmp2 = A_QA[k - n - 1];
            int64_t tmp64 = RSHIFT_ROUND64(
                (int64_t)SUB_SAT32(tmp1, MUL32_FRAC_Q(tmp2, rc_Q31, 31)) *
                    rc_mult2,
                mult2Q);
            if (tmp64 > INT32_MAX || tmp64 < INT32_MIN) return 0;
            A_QA[n] = (int32_t)tmp64;
            tmp64 = RSHIFT_ROUND64(
                (int64_t)SUB_SAT32(tmp2, MUL32_FRAC_Q(tmp1, rc_Q31, 31)) *
                    rc_mult2,
                mult2Q);
            if (tmp64 > INT32_MAX || tmp64 < INT32_MIN) return 0;
            A_QA[k - n - 1] = (int32_t)tmp64;
        }
    }
    if (A_QA[0] > kALimit || A_QA[0] < -kALimit) return 0;
    int32_t rc_Q31 = -(int32_t)((uint32_t)A_QA[0] << (31 - kQA24));
    int32_t rc_mult1_Q30 = ((int32_t)1 << 30) - SMMUL(rc_Q31, rc_Q31);
    invGain_Q30 = (int32_t)((uint32_t)SMMUL(invGain_Q30, rc_mult1_Q30) << 2);
    if (invGain_Q30 < kInvMaxPredGain) return 0;
    return invGain_Q30;
}

int32_t LPC_inverse_pred_gain(const int16_t* A_Q12, int order) {
    int32_t Atmp_QA[16];
    int32_t DC_resp = 0;
    for (int k = 0; k < order; k++) {
        DC_resp += (int32_t)A_Q12[k];
        Atmp_QA[k] = (int32_t)((uint32_t)A_Q12[k] << (kQA24 - 12));
    }
    if (DC_resp >= 4096) return 0;
    return LPC_inverse_pred_gain_QA(Atmp_QA, order);
}

// silk/LPC_analysis_filter.c (generic branch): FIR rewhitening
void LPC_analysis_filter(int16_t* out, const int16_t* in, const int16_t* B,
                         int len, int d) {
    for (int ix = d; ix < len; ix++) {
        const int16_t* in_ptr = &in[ix - 1];
        uint32_t out32_Q12 = (uint32_t)SMULBB(in_ptr[0], B[0]);
        for (int j = 1; j < d; j++)
            out32_Q12 += (uint32_t)SMULBB(in_ptr[-j], B[j]);
        out32_Q12 = (uint32_t)((int32_t)((uint32_t)in_ptr[1] << 12)) -
                    out32_Q12;
        int32_t out32 = RSHIFT_ROUND((int32_t)out32_Q12, 12);
        out[ix] = (int16_t)SAT16(out32);
    }
    memset(out, 0, d * sizeof(int16_t));
}


// ---------------------------------------------------------------------------
// Packet-loss concealment + comfort noise + glue (silk/PLC.c, CNG.c).
// State layout (owned by Python, see native.SilkPlcState):
//   plc_i32: [0]=pitchL_Q8 [1]=rand_seed [2]=conc_energy
//            [3]=conc_energy_shift [4]=last_frame_lost [5]=fs_khz
//            [6]=nb_subfr [7]=subfr_length [8..9]=prevGain_Q16
//   plc_i16: [0..4]=LTPCoef_Q14 [5..20]=prevLPC_Q12 [21]=randScale_Q14
//            [22]=prevLTP_scale_Q14
//   cng_i32: [0]=smth_Gain_Q16 [1]=rand_seed [2]=fs_khz
//            [3..18]=synth_state [19..338]=exc_buf_Q14
//   misc:    [0]=lossCnt [1]=prevSignalType [2]=first_frame_after_reset
//            [3]=lagPrev
//   cng_i16: [0..15]=smth_NLSF_Q15

static void sum_sqr_shift(int32_t* energy, int* shift, const int16_t* x,
                          int len) {
    // silk/sum_sqr_shift.c
    int shft = 31 - CLZ32(len);
    int32_t nrg = len;
    int i;
    for (i = 0; i < len - 1; i += 2) {
        uint32_t t = (uint32_t)SMULBB(x[i], x[i]);
        t += (uint32_t)SMULBB(x[i + 1], x[i + 1]);
        nrg = (int32_t)((uint32_t)nrg + (t >> shft));
    }
    if (i < len) {
        uint32_t t = (uint32_t)SMULBB(x[i], x[i]);
        nrg = (int32_t)((uint32_t)nrg + (t >> shft));
    }
    shft = 0 > shft + 3 - CLZ32(nrg) ? 0 : shft + 3 - CLZ32(nrg);
    nrg = 0;
    for (i = 0; i < len - 1; i += 2) {
        uint32_t t = (uint32_t)SMULBB(x[i], x[i]);
        t += (uint32_t)SMULBB(x[i + 1], x[i + 1]);
        nrg = (int32_t)((uint32_t)nrg + (t >> shft));
    }
    if (i < len) {
        uint32_t t = (uint32_t)SMULBB(x[i], x[i]);
        nrg = (int32_t)((uint32_t)nrg + (t >> shft));
    }
    *shift = shft;
    *energy = nrg;
}

static void bwexpander_16(int16_t* ar, int d, int32_t chirp_Q16) {
    // silk/bwexpander.c (deliberately not SMULWB, see its comment)
    int32_t chirp_minus_one_Q16 = chirp_Q16 - 65536;
    for (int i = 0; i < d - 1; i++) {
        ar[i] = (int16_t)RSHIFT_ROUND(
            (int32_t)((int64_t)chirp_Q16 * ar[i]), 16);
        chirp_Q16 += RSHIFT_ROUND(
            (int32_t)((int64_t)chirp_Q16 * chirp_minus_one_Q16), 16);
    }
    ar[d - 1] = (int16_t)RSHIFT_ROUND(
        (int32_t)((int64_t)chirp_Q16 * ar[d - 1]), 16);
}

static int32_t SQRT_APPROX(int32_t x) {
    // silk/Inlines.h silk_SQRT_APPROX
    if (x <= 0) return 0;
    int lz = CLZ32(x);
    // silk_CLZ_FRAC: 7 bits after the leading one (via rotate)
    uint32_t ux = (uint32_t)x;
    int rot = (24 - lz) & 31;
    int32_t frac_Q7 =
        (int32_t)(((ux >> rot) | (ux << ((32 - rot) & 31))) & 0x7f);
    int32_t y = (lz & 1) ? 32768 : 46214;
    y >>= (lz >> 1);
    y = SMLAWB(y, y, SMULBB(213, frac_Q7));
    return y;
}

static const int16_t HARM_ATT_Q15[2] = {32440, 31130};
static const int16_t PLC_RAND_ATT_V_Q15[2] = {31130, 26214};
static const int16_t PLC_RAND_ATT_UV_Q15[2] = {32440, 29491};

static void plc_reset(int32_t* plc_i32, int frame_length) {
    plc_i32[0] = (int32_t)((uint32_t)frame_length << 7);  // pitchL_Q8
    plc_i32[8] = 1 << 16;
    plc_i32[9] = 1 << 16;
    plc_i32[6] = 2;    // nb_subfr
    plc_i32[7] = 20;   // subfr_length
}

static void plc_update(int32_t* plc_i32, int16_t* plc_i16,
                       int32_t* misc, int signalType, int nb_subfr,
                       int subfr_length, int lpc_order,
                       const int16_t* A_Q12_both,
                       const int16_t* B_Q14_all,
                       const int32_t* Gains_Q16, const int32_t* pitchL,
                       int LTP_scale_Q14, int fs_khz) {
    // silk/PLC.c:119-190 silk_PLC_update
    misc[1] = signalType;   // prevSignalType (also done by caller)
    int32_t LTP_Gain_Q14 = 0;
    int16_t* pLTP = &plc_i16[0];
    if (signalType == 2) {
        for (int j = 0; j * subfr_length < pitchL[nb_subfr - 1]; j++) {
            if (j == nb_subfr) break;
            int32_t tmp = 0;
            for (int i = 0; i < 5; i++)
                tmp += B_Q14_all[(nb_subfr - 1 - j) * 5 + i];
            if (tmp > LTP_Gain_Q14) {
                LTP_Gain_Q14 = tmp;
                memcpy(pLTP, &B_Q14_all[(nb_subfr - 1 - j) * 5],
                       5 * sizeof(int16_t));
                plc_i32[0] =
                    (int32_t)((uint32_t)pitchL[nb_subfr - 1 - j] << 8);
            }
        }
        memset(pLTP, 0, 5 * sizeof(int16_t));
        pLTP[2] = (int16_t)LTP_Gain_Q14;
        if (LTP_Gain_Q14 < 11469) {
            int32_t scale_Q10 =
                ((int32_t)((uint32_t)11469 << 10)) /
                (LTP_Gain_Q14 > 1 ? LTP_Gain_Q14 : 1);
            for (int i = 0; i < 5; i++)
                pLTP[i] = (int16_t)(SMULBB(pLTP[i], scale_Q10) >> 10);
        } else if (LTP_Gain_Q14 > 15565) {
            int32_t scale_Q14 =
                ((int32_t)((uint32_t)15565 << 14)) /
                (LTP_Gain_Q14 > 1 ? LTP_Gain_Q14 : 1);
            for (int i = 0; i < 5; i++)
                pLTP[i] = (int16_t)(SMULBB(pLTP[i], scale_Q14) >> 14);
        }
    } else {
        plc_i32[0] = (int32_t)((uint32_t)SMULBB(fs_khz, 18) << 8);
        memset(pLTP, 0, 5 * sizeof(int16_t));
    }
    memcpy(&plc_i16[5], &A_Q12_both[16], lpc_order * sizeof(int16_t));
    plc_i16[22] = (int16_t)LTP_scale_Q14;
    plc_i32[8] = Gains_Q16[nb_subfr - 2];
    plc_i32[9] = Gains_Q16[nb_subfr - 1];
    plc_i32[7] = subfr_length;
    plc_i32[6] = nb_subfr;
}

static void plc_conceal(int32_t* plc_i32, int16_t* plc_i16,
                        int32_t* misc, int32_t* exc_Q14,
                        int16_t* outBuf, int32_t* sLPC_Q14_buf,
                        int frame_length, int subfr_length, int nb_subfr,
                        int lpc_order, int ltp_mem_length, int fs_khz,
                        int32_t* pitchL_out, int16_t* frame) {
    // silk/PLC.c:216-432 silk_PLC_conceal
    const int MAX_LPC_ORDER = 16, LTP_ORDER = 5, RAND_BUF_SIZE = 128;
    int16_t sLTP[640];
    int32_t sLTP_Q14[640 + 320 + MAX_LPC_ORDER];
    int32_t prevGain_Q10[2] = {plc_i32[8] >> 6, plc_i32[9] >> 6};
    if (misc[2]) memset(&plc_i16[5], 0, 16 * sizeof(int16_t));

    // silk_PLC_energy over the last two subframes of the saved exc
    int32_t energy1, energy2;
    int shift1, shift2;
    {
        int16_t exc_buf[2 * 160];
        for (int k = 0; k < 2; k++)
            for (int i = 0; i < subfr_length; i++)
                exc_buf[k * subfr_length + i] = (int16_t)SAT16(
                    SMULWW(exc_Q14[i + (k + nb_subfr - 2) * subfr_length],
                           prevGain_Q10[k]) >> 8);
        sum_sqr_shift(&energy1, &shift1, exc_buf, subfr_length);
        sum_sqr_shift(&energy2, &shift2, &exc_buf[subfr_length],
                      subfr_length);
    }
    const int32_t* rand_ptr;
    int plc_nb_subfr = plc_i32[6], plc_subfr_len = plc_i32[7];
    if ((energy1 >> shift2) < (energy2 >> shift1)) {
        int off = (plc_nb_subfr - 1) * plc_subfr_len - RAND_BUF_SIZE;
        rand_ptr = &exc_Q14[off > 0 ? off : 0];
    } else {
        int off = plc_nb_subfr * plc_subfr_len - RAND_BUF_SIZE;
        rand_ptr = &exc_Q14[off > 0 ? off : 0];
    }
    int16_t* B_Q14 = &plc_i16[0];
    int16_t rand_scale_Q14 = plc_i16[21];
    int lossCnt = misc[0];
    int prevSignalType = misc[1];
    int att = lossCnt < 1 ? lossCnt : 1;
    int32_t harm_Gain_Q15 = HARM_ATT_Q15[att];
    int32_t rand_Gain_Q15 = prevSignalType == 2
                                ? PLC_RAND_ATT_V_Q15[att]
                                : PLC_RAND_ATT_UV_Q15[att];
    // BWE_COEF = 0.99 in Q16
    bwexpander_16(&plc_i16[5], lpc_order,
                  (int32_t)(0.99 * 65536.0 + 0.5));
    int16_t A_Q12[16];
    memcpy(A_Q12, &plc_i16[5], lpc_order * sizeof(int16_t));

    if (lossCnt == 0) {
        rand_scale_Q14 = 1 << 14;
        if (prevSignalType == 2) {
            for (int i = 0; i < LTP_ORDER; i++)
                rand_scale_Q14 -= B_Q14[i];
            rand_scale_Q14 =
                rand_scale_Q14 > 3277 ? rand_scale_Q14 : 3277;
            rand_scale_Q14 = (int16_t)(
                SMULBB(rand_scale_Q14, plc_i16[22]) >> 14);
        } else {
            int32_t invGain_Q30 =
                LPC_inverse_pred_gain(&plc_i16[5], lpc_order);
            int32_t down_scale_Q30 = ((int32_t)1 << 30) >> 3;
            if (invGain_Q30 < down_scale_Q30)
                down_scale_Q30 = invGain_Q30;
            if (down_scale_Q30 < ((int32_t)1 << 30) >> 8)
                down_scale_Q30 = ((int32_t)1 << 30) >> 8;
            down_scale_Q30 = (int32_t)((uint32_t)down_scale_Q30 << 3);
            rand_Gain_Q15 =
                SMULWB(down_scale_Q30, rand_Gain_Q15) >> 14;
        }
    }
    int32_t rand_seed = plc_i32[1];
    int lag = RSHIFT_ROUND(plc_i32[0], 8);
    int sLTP_buf_idx = ltp_mem_length;
    int idx = ltp_mem_length - lag - lpc_order - LTP_ORDER / 2;
    if (idx <= 0) idx = 1;
    LPC_analysis_filter(&sLTP[idx], &outBuf[idx], A_Q12,
                        ltp_mem_length - idx, lpc_order);
    int32_t inv_gain_Q30 = INVERSE32_varQ(plc_i32[9], 46);
    if (inv_gain_Q30 > (INT32_MAX >> 1)) inv_gain_Q30 = INT32_MAX >> 1;
    for (int i = idx + lpc_order; i < ltp_mem_length; i++)
        sLTP_Q14[i] = SMULWB(inv_gain_Q30, sLTP[i]);

    for (int k = 0; k < nb_subfr; k++) {
        const int32_t* pred_lag_ptr =
            &sLTP_Q14[sLTP_buf_idx - lag + LTP_ORDER / 2];
        for (int i = 0; i < subfr_length; i++) {
            int32_t LTP_pred_Q12 = 2;
            LTP_pred_Q12 = SMLAWB(LTP_pred_Q12, pred_lag_ptr[0], B_Q14[0]);
            LTP_pred_Q12 =
                SMLAWB(LTP_pred_Q12, pred_lag_ptr[-1], B_Q14[1]);
            LTP_pred_Q12 =
                SMLAWB(LTP_pred_Q12, pred_lag_ptr[-2], B_Q14[2]);
            LTP_pred_Q12 =
                SMLAWB(LTP_pred_Q12, pred_lag_ptr[-3], B_Q14[3]);
            LTP_pred_Q12 =
                SMLAWB(LTP_pred_Q12, pred_lag_ptr[-4], B_Q14[4]);
            pred_lag_ptr++;
            rand_seed =
                (int32_t)(907633515u + (uint32_t)rand_seed * 196314165u);
            int ridx = (rand_seed >> 25) & (RAND_BUF_SIZE - 1);
            sLTP_Q14[sLTP_buf_idx] = (int32_t)(
                (uint32_t)SMLAWB(LTP_pred_Q12, rand_ptr[ridx],
                                 rand_scale_Q14)
                << 2);
            sLTP_buf_idx++;
        }
        for (int j = 0; j < LTP_ORDER; j++)
            B_Q14[j] = (int16_t)(SMULBB(harm_Gain_Q15, B_Q14[j]) >> 15);
        rand_scale_Q14 =
            (int16_t)(SMULBB(rand_scale_Q14, rand_Gain_Q15) >> 15);
        plc_i32[0] = SMLAWB(plc_i32[0], plc_i32[0], 655);
        int32_t maxlag = (int32_t)((uint32_t)SMULBB(18, fs_khz) << 8);
        if (plc_i32[0] > maxlag) plc_i32[0] = maxlag;
        lag = RSHIFT_ROUND(plc_i32[0], 8);
    }

    int32_t* sLPC_Q14_ptr = &sLTP_Q14[ltp_mem_length - 16];
    memcpy(sLPC_Q14_ptr, sLPC_Q14_buf, 16 * sizeof(int32_t));
    for (int i = 0; i < frame_length; i++) {
        int32_t LPC_pred_Q10 = lpc_order >> 1;
        for (int j = 0; j < lpc_order; j++)
            LPC_pred_Q10 = SMLAWB(LPC_pred_Q10,
                                  sLPC_Q14_ptr[16 + i - 1 - j], A_Q12[j]);
        sLPC_Q14_ptr[16 + i] = ADD_SAT32(sLPC_Q14_ptr[16 + i],
                                         LSHIFT_SAT32(LPC_pred_Q10, 4));
        frame[i] = (int16_t)SAT16(SAT16(RSHIFT_ROUND(
            SMULWW(sLPC_Q14_ptr[16 + i], prevGain_Q10[1]), 8)));
    }
    memcpy(sLPC_Q14_buf, &sLPC_Q14_ptr[frame_length],
           16 * sizeof(int32_t));
    plc_i32[1] = rand_seed;
    plc_i16[21] = rand_scale_Q14;
    for (int i = 0; i < 4; i++) pitchL_out[i] = lag;
}

static void cng_reset(int32_t* cng_i32, int16_t* cng_i16, int lpc_order) {
    int32_t step = 32767 / (lpc_order + 1);
    int32_t acc = 0;
    for (int i = 0; i < lpc_order; i++) {
        acc += step;
        cng_i16[i] = (int16_t)acc;
    }
    cng_i32[0] = 0;
    cng_i32[1] = 3176576;
}

static void cng_frame(int32_t* cng_i32, int16_t* cng_i16,
                      int32_t* plc_i32, int16_t* plc_i16, int32_t* misc,
                      const int16_t* prevNLSF_Q15, const int32_t* exc_Q14,
                      const int32_t* Gains_Q16, const int16_t* cos_tab,
                      int signalType, int nb_subfr, int subfr_length,
                      int lpc_order, int fs_khz, int16_t* frame,
                      int length) {
    // silk/CNG.c silk_CNG
    const int MAX_LPC_ORDER = 16;
    int32_t* synth_state = &cng_i32[3];
    int32_t* exc_buf = &cng_i32[19];
    if (fs_khz != cng_i32[2]) {
        cng_reset(cng_i32, cng_i16, lpc_order);
        cng_i32[2] = fs_khz;
    }
    if (misc[0] == 0 && misc[1] == 0) {
        // lossCnt == 0 && prevSignalType == TYPE_NO_VOICE_ACTIVITY
        for (int i = 0; i < lpc_order; i++)
            cng_i16[i] = (int16_t)(cng_i16[i] +
                SMULWB((int32_t)prevNLSF_Q15[i] - cng_i16[i], 16348));
        int32_t max_Gain = 0;
        int subfr = 0;
        for (int i = 0; i < nb_subfr; i++)
            if (Gains_Q16[i] > max_Gain) {
                max_Gain = Gains_Q16[i];
                subfr = i;
            }
        memmove(&exc_buf[subfr_length], exc_buf,
                (nb_subfr - 1) * subfr_length * sizeof(int32_t));
        memcpy(exc_buf, &exc_Q14[subfr * subfr_length],
               subfr_length * sizeof(int32_t));
        for (int i = 0; i < nb_subfr; i++) {
            cng_i32[0] +=
                SMULWB(Gains_Q16[i] - cng_i32[0], 4634);
            if (SMULWW(cng_i32[0], 46396) > Gains_Q16[i])
                cng_i32[0] = Gains_Q16[i];
        }
    }
    if (misc[0]) {   // lossCnt: add comfort noise
        int32_t CNG_sig_Q14[320 + MAX_LPC_ORDER];
        int32_t gain_Q16 = SMULWW(plc_i16[21], plc_i32[9]);
        if (gain_Q16 >= (1 << 21) || cng_i32[0] > (1 << 23)) {
            gain_Q16 = (gain_Q16 >> 16) * (gain_Q16 >> 16);
            gain_Q16 = (int32_t)(
                (uint32_t)((cng_i32[0] >> 16) * (cng_i32[0] >> 16)) -
                ((uint32_t)gain_Q16 << 5));
            gain_Q16 = (int32_t)((uint32_t)SQRT_APPROX(gain_Q16) << 16);
        } else {
            gain_Q16 = SMULWW(gain_Q16, gain_Q16);
            gain_Q16 = (int32_t)(
                (uint32_t)SMULWW(cng_i32[0], cng_i32[0]) -
                ((uint32_t)gain_Q16 << 5));
            gain_Q16 = (int32_t)((uint32_t)SQRT_APPROX(gain_Q16) << 8);
        }
        int32_t gain_Q10 = gain_Q16 >> 6;
        // silk_CNG_exc
        int exc_mask = 255;
        while (exc_mask > length) exc_mask >>= 1;
        int32_t seed = cng_i32[1];
        for (int i = 0; i < length; i++) {
            seed = (int32_t)(907633515u + (uint32_t)seed * 196314165u);
            int idx2 = (seed >> 24) & exc_mask;
            CNG_sig_Q14[MAX_LPC_ORDER + i] = exc_buf[idx2];
        }
        cng_i32[1] = seed;
        int16_t A_Q12[16];
        silk_nlsf2a(cng_i16, lpc_order, cos_tab, A_Q12);
        memcpy(CNG_sig_Q14, synth_state, MAX_LPC_ORDER * sizeof(int32_t));
        for (int i = 0; i < length; i++) {
            int32_t LPC_pred_Q10 = lpc_order >> 1;
            for (int j = 0; j < lpc_order; j++)
                LPC_pred_Q10 =
                    SMLAWB(LPC_pred_Q10,
                           CNG_sig_Q14[MAX_LPC_ORDER + i - 1 - j],
                           A_Q12[j]);
            CNG_sig_Q14[MAX_LPC_ORDER + i] =
                ADD_SAT32(CNG_sig_Q14[MAX_LPC_ORDER + i],
                          LSHIFT_SAT32(LPC_pred_Q10, 4));
            int32_t add = SAT16(RSHIFT_ROUND(
                SMULWW(CNG_sig_Q14[MAX_LPC_ORDER + i], gain_Q10), 8));
            int32_t s = frame[i] + add;
            frame[i] = (int16_t)SAT16(s);
        }
        memcpy(synth_state, &CNG_sig_Q14[length],
               MAX_LPC_ORDER * sizeof(int32_t));
    } else {
        memset(synth_state, 0, lpc_order * sizeof(int32_t));
    }
}

static void plc_glue(int32_t* plc_i32, int32_t* misc, int16_t* frame,
                     int length) {
    // silk/PLC.c silk_PLC_glue_frames
    if (misc[0]) {
        sum_sqr_shift(&plc_i32[2], (int*)&plc_i32[3], frame, length);
        plc_i32[4] = 1;
    } else if (plc_i32[4]) {
        int32_t energy;
        int energy_shift;
        sum_sqr_shift(&energy, &energy_shift, frame, length);
        if (energy_shift > plc_i32[3])
            plc_i32[2] >>= energy_shift - plc_i32[3];
        else if (energy_shift < plc_i32[3])
            energy >>= plc_i32[3] - energy_shift;
        if (energy > plc_i32[2]) {
            int32_t LZ = CLZ32(plc_i32[2]) - 1;
            plc_i32[2] = (int32_t)((uint32_t)plc_i32[2] << LZ);
            int sh = 24 - LZ > 0 ? 24 - LZ : 0;
            energy >>= sh;
            int32_t frac_Q24 =
                plc_i32[2] / (energy > 1 ? energy : 1);
            int32_t gain_Q16 =
                (int32_t)((uint32_t)SQRT_APPROX(frac_Q24) << 4);
            int32_t slope_Q16 = (((int32_t)1 << 16) - gain_Q16) / length;
            slope_Q16 = (int32_t)((uint32_t)slope_Q16 << 2);
            for (int i = 0; i < length; i++) {
                frame[i] = (int16_t)SMULWB(gain_Q16, frame[i]);
                gain_Q16 += slope_Q16;
                if (gain_Q16 > (int32_t)1 << 16) break;
            }
        }
        plc_i32[4] = 0;
    } else {
        plc_i32[4] = 0;
    }
}

}  // namespace

extern "C" {

// silk/NLSF2A.c — Q15 NLSFs to stabilised Q12 int16 LPC coefficients
void silk_nlsf2a(const int16_t* nlsf_q15, int d,
                 const int16_t* cos_tab_q12, int16_t* a_q12) {
    static const unsigned char ordering16[16] = {0, 15, 8,  7, 4, 11, 12, 3,
                                                 2, 13, 10, 5, 6, 9,  14, 1};
    static const unsigned char ordering10[10] = {0, 9, 6, 3, 4,
                                                 5, 8, 1, 2, 7};
    const unsigned char* ordering = d == 16 ? ordering16 : ordering10;
    const int QA = 16;
    int32_t cos_LSF_QA[16];
    for (int k = 0; k < d; k++) {
        int32_t f_int = nlsf_q15[k] >> (15 - 7);
        int32_t f_frac = nlsf_q15[k] - (f_int << (15 - 7));
        int32_t cos_val = cos_tab_q12[f_int];
        int32_t delta = cos_tab_q12[f_int + 1] - cos_val;
        cos_LSF_QA[ordering[k]] =
            RSHIFT_ROUND((int32_t)((uint32_t)cos_val << 8) + delta * f_frac,
                         20 - QA);
    }
    int dd = d >> 1;
    int32_t P[9], Q[9];
    for (int half = 0; half < 2; half++) {
        int32_t* out = half ? Q : P;
        const int32_t* cLSF = &cos_LSF_QA[half];
        out[0] = (int32_t)1 << QA;
        out[1] = -cLSF[0];
        for (int k = 1; k < dd; k++) {
            int32_t ftmp = cLSF[2 * k];
            out[k + 1] =
                (int32_t)((uint32_t)out[k - 1] << 1) -
                (int32_t)RSHIFT_ROUND64((int64_t)ftmp * out[k], QA);
            for (int n = k; n > 1; n--)
                out[n] += out[n - 2] -
                          (int32_t)RSHIFT_ROUND64((int64_t)ftmp * out[n - 1],
                                                  QA);
            out[1] -= ftmp;
        }
    }
    int32_t a32_QA1[16];
    for (int k = 0; k < dd; k++) {
        int32_t Ptmp = P[k + 1] + P[k];
        int32_t Qtmp = Q[k + 1] - Q[k];
        a32_QA1[k] = -Qtmp - Ptmp;
        a32_QA1[d - k - 1] = Qtmp - Ptmp;
    }
    LPC_fit(a_q12, a32_QA1, 12, QA + 1, d);
    for (int i = 0; LPC_inverse_pred_gain(a_q12, d) == 0 && i < 16; i++) {
        bwexpander_32(a32_QA1, d, 65536 - (2 << i));
        LPC_fit(a_q12, a32_QA1, 12, QA + 1, d);
    }
}

// silk/decode_core.c — one frame of inverse NSQ (LTP + LPC synthesis).
// outBuf: int16[ltp_mem + frame_length] persistent history, shifted here
// exactly as silk_decode_frame does (decode_frame.c:150-153).
// sLPC_Q14: int32[16] persistent; prev_gain_Q16: int32[1] persistent.
// exc_out_Q14: int32[frame_length] excitation (for PLC).
// Returns 0.
int silk_decode_core_fix(
    const int16_t* pulses, int frame_length, int subfr_length, int nb_subfr,
    int lpc_order, int ltp_mem_length, const int16_t* A_Q12_both,
    const int16_t* B_Q14_in, const int32_t* Gains_Q16,
    const int32_t* pitchL_in, int LTP_scale_Q14, int signalTypeInd,
    int quantOffsetType, int32_t seed, int nlsf_interp_flag,
    int16_t* outBuf, int32_t* sLPC_Q14_buf, int32_t* prev_gain_Q16,
    int32_t* exc_out_Q14, int16_t* xq, int lossCnt, int prevSignalType,
    int lagPrev, int32_t* pitchL_used) {
    // silk/tables_other.c:82 silk_Quantization_Offsets_Q10
    // ({UVL,UVH},{VL,VH} from define.h:130-133)
    static const int32_t quant_offs[2][2] = {{100, 240}, {32, 100}};
    int32_t offset_Q10 = quant_offs[signalTypeInd >> 1][quantOffsetType];
    // local copies: the voiced-PLC transition below mutates taps/lags
    // (decode_core.c:124-133)
    int16_t B_Q14_all[4 * 5];
    int32_t pitchL[4];
    memcpy(B_Q14_all, B_Q14_in, nb_subfr * 5 * sizeof(int16_t));
    memcpy(pitchL, pitchL_in, nb_subfr * sizeof(int32_t));
    int sigType_k[4];
    for (int k = 0; k < nb_subfr; k++) {
        sigType_k[k] = signalTypeInd;
        if (lossCnt && prevSignalType == 2 && signalTypeInd != 2 &&
            k < 2) {
            memset(&B_Q14_all[k * 5], 0, 5 * sizeof(int16_t));
            B_Q14_all[k * 5 + 5 / 2] = (int16_t)(0.25 * 16384.0 + 0.5);
            sigType_k[k] = 2;
            pitchL[k] = lagPrev;
        }
    }
    if (pitchL_used != nullptr)
        memcpy(pitchL_used, pitchL, nb_subfr * sizeof(int32_t));

    int32_t rand_seed = seed;
    for (int i = 0; i < frame_length; i++) {
        rand_seed = (int32_t)(907633515u + (uint32_t)rand_seed * 196314165u);
        int32_t e = (int32_t)((uint32_t)pulses[i] << 14);
        if (e > 0)
            e -= 80 << 4;  // QUANT_LEVEL_ADJUST_Q10 << 4
        else if (e < 0)
            e += 80 << 4;
        e += offset_Q10 << 4;
        if (rand_seed < 0) e = -e;
        exc_out_Q14[i] = e;
        rand_seed = (int32_t)((uint32_t)rand_seed + (uint32_t)pulses[i]);
    }

    const int MAX_LPC_ORDER = 16, LTP_ORDER = 5;
    int32_t sLPC_Q14[16 + 480];  // MAX_LPC_ORDER + max subfr_length
    int32_t res_Q14_buf[480];
    int16_t sLTP[640];                 // ltp_mem max 20 ms @ 16 kHz = 320
    int32_t sLTP_Q15[640 + 320 + 16];  // ltp_mem + frame_length
    memcpy(sLPC_Q14, sLPC_Q14_buf, MAX_LPC_ORDER * sizeof(int32_t));

    const int32_t* pexc_Q14 = exc_out_Q14;
    int16_t* pxq = xq;
    int sLTP_buf_idx = ltp_mem_length;
    int lag = 0;
    for (int k = 0; k < nb_subfr; k++) {
        const int32_t* pres_Q14 = res_Q14_buf;
        const int16_t* A_Q12 = &A_Q12_both[(k >> 1) * 16];
        const int16_t* B_Q14 = &B_Q14_all[k * LTP_ORDER];
        int signalType = sigType_k[k];

        int32_t Gain_Q10 = Gains_Q16[k] >> 6;
        int32_t inv_gain_Q31 = INVERSE32_varQ(Gains_Q16[k], 47);

        int32_t gain_adj_Q16;
        if (Gains_Q16[k] != *prev_gain_Q16) {
            gain_adj_Q16 = DIV32_varQ(*prev_gain_Q16, Gains_Q16[k], 16);
            for (int i = 0; i < MAX_LPC_ORDER; i++)
                sLPC_Q14[i] = SMULWW(gain_adj_Q16, sLPC_Q14[i]);
        } else {
            gain_adj_Q16 = (int32_t)1 << 16;
        }
        *prev_gain_Q16 = Gains_Q16[k];

        if (signalType == 2) {  // TYPE_VOICED
            lag = pitchL[k];
            if (k == 0 || (k == 2 && nlsf_interp_flag)) {
                int start_idx =
                    ltp_mem_length - lag - lpc_order - LTP_ORDER / 2;
                if (start_idx <= 0) return -1;
                if (k == 2)
                    memcpy(&outBuf[ltp_mem_length], xq,
                           2 * subfr_length * sizeof(int16_t));
                LPC_analysis_filter(&sLTP[start_idx],
                                    &outBuf[start_idx + k * subfr_length],
                                    A_Q12, ltp_mem_length - start_idx,
                                    lpc_order);
                if (k == 0)
                    inv_gain_Q31 = (int32_t)(
                        (uint32_t)SMULWB(inv_gain_Q31, LTP_scale_Q14) << 2);
                for (int i = 0; i < lag + LTP_ORDER / 2; i++)
                    sLTP_Q15[sLTP_buf_idx - i - 1] =
                        SMULWB(inv_gain_Q31, sLTP[ltp_mem_length - i - 1]);
            } else if (gain_adj_Q16 != (int32_t)1 << 16) {
                for (int i = 0; i < lag + LTP_ORDER / 2; i++)
                    sLTP_Q15[sLTP_buf_idx - i - 1] =
                        SMULWW(gain_adj_Q16, sLTP_Q15[sLTP_buf_idx - i - 1]);
            }
        }

        if (signalType == 2) {
            const int32_t* pred_lag_ptr =
                &sLTP_Q15[sLTP_buf_idx - lag + LTP_ORDER / 2];
            for (int i = 0; i < subfr_length; i++) {
                int32_t LTP_pred_Q13 = 2;
                LTP_pred_Q13 = SMLAWB(LTP_pred_Q13, pred_lag_ptr[0], B_Q14[0]);
                LTP_pred_Q13 =
                    SMLAWB(LTP_pred_Q13, pred_lag_ptr[-1], B_Q14[1]);
                LTP_pred_Q13 =
                    SMLAWB(LTP_pred_Q13, pred_lag_ptr[-2], B_Q14[2]);
                LTP_pred_Q13 =
                    SMLAWB(LTP_pred_Q13, pred_lag_ptr[-3], B_Q14[3]);
                LTP_pred_Q13 =
                    SMLAWB(LTP_pred_Q13, pred_lag_ptr[-4], B_Q14[4]);
                pred_lag_ptr++;
                res_Q14_buf[i] = (int32_t)((uint32_t)pexc_Q14[i] +
                                           ((uint32_t)LTP_pred_Q13 << 1));
                sLTP_Q15[sLTP_buf_idx] =
                    (int32_t)((uint32_t)res_Q14_buf[i] << 1);
                sLTP_buf_idx++;
            }
        } else {
            pres_Q14 = pexc_Q14;
        }

        for (int i = 0; i < subfr_length; i++) {
            int32_t LPC_pred_Q10 = lpc_order >> 1;
            for (int j = 0; j < lpc_order; j++)
                LPC_pred_Q10 = SMLAWB(LPC_pred_Q10,
                                      sLPC_Q14[MAX_LPC_ORDER + i - 1 - j],
                                      A_Q12[j]);
            sLPC_Q14[MAX_LPC_ORDER + i] =
                ADD_SAT32(pres_Q14[i], LSHIFT_SAT32(LPC_pred_Q10, 4));
            pxq[i] = (int16_t)SAT16(RSHIFT_ROUND(
                SMULWW(sLPC_Q14[MAX_LPC_ORDER + i], Gain_Q10), 8));
        }
        memcpy(sLPC_Q14, &sLPC_Q14[subfr_length],
               MAX_LPC_ORDER * sizeof(int32_t));
        pexc_Q14 += subfr_length;
        pxq += subfr_length;
    }
    memcpy(sLPC_Q14_buf, sLPC_Q14, MAX_LPC_ORDER * sizeof(int32_t));

    // decode_frame.c:150-153 — shift outBuf history and append xq
    int mv_len = ltp_mem_length - frame_length;
    memmove(outBuf, &outBuf[frame_length], mv_len * sizeof(int16_t));
    memcpy(&outBuf[mv_len], xq, frame_length * sizeof(int16_t));
    return 0;
}

// silk/resampler_private_IIR_FIR.c + up2_HQ: fs_in -> 48 kHz upsampler.
// sIIR: int32[6]; sFIR: int16[8]; coefs are the Q15/Q16 ROM constants
// resampler_rom.h:silk_resampler_up2_hq_0/1 passed from Python tables.
// Returns the number of output samples written.
int silk_resampler_iir_fir(const int16_t* in, int in_len, int batch_size,
                           int32_t index_increment_Q16, int32_t* sIIR,
                           int16_t* sFIR, const int16_t* up2_hq_coefs,
                           const int16_t* frac_fir_12, int16_t* out) {
    const int FIR_ORDER = 8;
    int16_t buf[2 * 480 + 8];
    const int16_t* c0 = up2_hq_coefs;      // [3] even phase
    const int16_t* c1 = up2_hq_coefs + 3;  // [3] odd phase
    int n_out = 0;
    memcpy(buf, sFIR, FIR_ORDER * sizeof(int16_t));
    while (1) {
        int n = in_len < batch_size ? in_len : batch_size;
        // up2_HQ into buf[FIR_ORDER..]
        int16_t* o = &buf[FIR_ORDER];
        for (int k = 0; k < n; k++) {
            int32_t in32 = (int32_t)((uint32_t)in[k] << 10);
            int32_t Y = in32 - sIIR[0];
            int32_t X = SMULWB(Y, c0[0]);
            int32_t out32_1 = sIIR[0] + X;
            sIIR[0] = in32 + X;
            Y = out32_1 - sIIR[1];
            X = SMULWB(Y, c0[1]);
            int32_t out32_2 = sIIR[1] + X;
            sIIR[1] = out32_1 + X;
            Y = out32_2 - sIIR[2];
            X = SMLAWB(Y, Y, c0[2]);
            out32_1 = sIIR[2] + X;
            sIIR[2] = out32_2 + X;
            o[2 * k] = (int16_t)SAT16(RSHIFT_ROUND(out32_1, 10));
            Y = in32 - sIIR[3];
            X = SMULWB(Y, c1[0]);
            out32_1 = sIIR[3] + X;
            sIIR[3] = in32 + X;
            Y = out32_1 - sIIR[4];
            X = SMULWB(Y, c1[1]);
            out32_2 = sIIR[4] + X;
            sIIR[4] = out32_1 + X;
            Y = out32_2 - sIIR[5];
            X = SMLAWB(Y, Y, c1[2]);
            out32_1 = sIIR[5] + X;
            sIIR[5] = out32_2 + X;
            o[2 * k + 1] = (int16_t)SAT16(RSHIFT_ROUND(out32_1, 10));
        }
        int32_t max_index_Q16 = (int32_t)((uint32_t)n << 17);
        for (int32_t index_Q16 = 0; index_Q16 < max_index_Q16;
             index_Q16 += index_increment_Q16) {
            int32_t ti = SMULWB(index_Q16 & 0xFFFF, 12);
            const int16_t* bp = &buf[index_Q16 >> 16];
            const int16_t* t0 = &frac_fir_12[ti * 4];
            const int16_t* t1 = &frac_fir_12[(11 - ti) * 4];
            int32_t res_Q15 = SMULBB(bp[0], t0[0]);
            res_Q15 += SMULBB(bp[1], t0[1]);
            res_Q15 += SMULBB(bp[2], t0[2]);
            res_Q15 += SMULBB(bp[3], t0[3]);
            res_Q15 += SMULBB(bp[4], t1[3]);
            res_Q15 += SMULBB(bp[5], t1[2]);
            res_Q15 += SMULBB(bp[6], t1[1]);
            res_Q15 += SMULBB(bp[7], t1[0]);
            out[n_out++] = (int16_t)SAT16(RSHIFT_ROUND(res_Q15, 15));
        }
        in += n;
        in_len -= n;
        if (in_len > 0) {
            memcpy(buf, &buf[n << 1], FIR_ORDER * sizeof(int16_t));
        } else {
            memcpy(sFIR, &buf[n << 1], FIR_ORDER * sizeof(int16_t));
            break;
        }
    }
    return n_out;
}

// silk/stereo_MS_to_LR.c — predict side from mid, convert to L/R.
// x1/x2: int16[frame_length + 2] with the 2-sample history prepended by
// this function from sMid/sSide (persistent int16[2] each).
int silk_stereo_ms_to_lr(int16_t* x1, int16_t* x2, int16_t* sMid,
                         int16_t* sSide, int32_t* pred_prev_Q13,
                         const int32_t* pred_Q13, int fs_khz,
                         int frame_length) {
    memcpy(x1, sMid, 2 * sizeof(int16_t));
    memcpy(x2, sSide, 2 * sizeof(int16_t));
    memcpy(sMid, &x1[frame_length], 2 * sizeof(int16_t));
    memcpy(sSide, &x2[frame_length], 2 * sizeof(int16_t));

    const int STEREO_INTERP_LEN_MS = 8;
    int interp_len = STEREO_INTERP_LEN_MS * fs_khz;
    int32_t pred0_Q13 = pred_prev_Q13[0];
    int32_t pred1_Q13 = pred_prev_Q13[1];
    int32_t denom_Q16 = (int32_t)(((int32_t)1 << 16) / interp_len);
    int32_t delta0_Q13 = RSHIFT_ROUND(
        SMULBB(pred_Q13[0] - pred_prev_Q13[0], denom_Q16), 16);
    int32_t delta1_Q13 = RSHIFT_ROUND(
        SMULBB(pred_Q13[1] - pred_prev_Q13[1], denom_Q16), 16);
    int n = 0;
    for (; n < interp_len && n < frame_length; n++) {
        pred0_Q13 += delta0_Q13;
        pred1_Q13 += delta1_Q13;
        int32_t sum = (int32_t)(
            (uint32_t)((x1[n] + (int32_t)x1[n + 2]) + ((int32_t)x1[n + 1] << 1))
            << 9);
        sum = SMLAWB((int32_t)((uint32_t)x2[n + 1] << 8), sum, pred0_Q13);
        sum = SMLAWB(sum, (int32_t)((uint32_t)x1[n + 1] << 11), pred1_Q13);
        x2[n + 1] = (int16_t)SAT16(RSHIFT_ROUND(sum, 8));
    }
    pred0_Q13 = pred_Q13[0];
    pred1_Q13 = pred_Q13[1];
    for (; n < frame_length; n++) {
        int32_t sum = (int32_t)(
            (uint32_t)((x1[n] + (int32_t)x1[n + 2]) + ((int32_t)x1[n + 1] << 1))
            << 9);
        sum = SMLAWB((int32_t)((uint32_t)x2[n + 1] << 8), sum, pred0_Q13);
        sum = SMLAWB(sum, (int32_t)((uint32_t)x1[n + 1] << 11), pred1_Q13);
        x2[n + 1] = (int16_t)SAT16(RSHIFT_ROUND(sum, 8));
    }
    pred_prev_Q13[0] = pred_Q13[0];
    pred_prev_Q13[1] = pred_Q13[1];

    for (n = 0; n < frame_length; n++) {
        int32_t sum = x1[n + 1] + (int32_t)x2[n + 1];
        int32_t diff = x1[n + 1] - (int32_t)x2[n + 1];
        x1[n + 1] = (int16_t)SAT16(sum);
        x2[n + 1] = (int16_t)SAT16(diff);
    }
    return 0;
}


// Full fixed-point SILK frame: decode (or conceal) + PLC bookkeeping +
// CNG + glue, mirroring silk_decode_frame (decode_frame.c:56-170).
// lost: 0 = normal decode, 1 = concealment (decode params ignored).
int silk_frame_fix(
    int lost, const int16_t* pulses, int frame_length, int subfr_length,
    int nb_subfr, int lpc_order, int ltp_mem_length,
    const int16_t* A_Q12_both, const int16_t* B_Q14_all,
    const int32_t* Gains_Q16, const int32_t* pitchL, int LTP_scale_Q14,
    int signalTypeInd, int quantOffsetType, int32_t seed,
    int nlsf_interp_flag, const int16_t* prevNLSF_Q15,
    const int16_t* cos_tab, int fs_khz,
    int16_t* outBuf, int32_t* sLPC_Q14_buf, int32_t* prev_gain_Q16,
    int32_t* exc_Q14_state, int32_t* plc_i32, int16_t* plc_i16,
    int32_t* cng_i32, int16_t* cng_i16, int32_t* misc, int16_t* xq) {
    if (fs_khz != plc_i32[5]) {
        plc_reset(plc_i32, frame_length);
        plc_i32[5] = fs_khz;
    }
    int32_t pitch_used[4] = {0, 0, 0, 0};
    if (!lost) {
        // decode_parameters.c:80-84 — after a packet loss, bandwidth-
        // expand both LPC coefficient halves (BWE_AFTER_LOSS_Q16)
        int16_t A_both[2 * 16];
        memcpy(A_both, A_Q12_both, sizeof(A_both));
        if (misc[0]) {
            bwexpander_16(&A_both[0], lpc_order, 63570);
            bwexpander_16(&A_both[16], lpc_order, 63570);
        }
        int rc = silk_decode_core_fix(
            pulses, frame_length, subfr_length, nb_subfr, lpc_order,
            ltp_mem_length, A_both, B_Q14_all, Gains_Q16, pitchL,
            LTP_scale_Q14, signalTypeInd, quantOffsetType, seed,
            nlsf_interp_flag, outBuf, sLPC_Q14_buf, prev_gain_Q16,
            exc_Q14_state, xq, misc[0], misc[1], misc[3], pitch_used);
        if (rc != 0) return rc;
        plc_update(plc_i32, plc_i16, misc, signalTypeInd, nb_subfr,
                   subfr_length, lpc_order, A_both, B_Q14_all,
                   Gains_Q16, pitch_used, LTP_scale_Q14, fs_khz);
        misc[0] = 0;
        misc[1] = signalTypeInd;
        misc[2] = 0;
        cng_frame(cng_i32, cng_i16, plc_i32, plc_i16, misc,
                  prevNLSF_Q15, exc_Q14_state, Gains_Q16, cos_tab,
                  signalTypeInd, nb_subfr, subfr_length, lpc_order,
                  fs_khz, xq, frame_length);
        plc_glue(plc_i32, misc, xq, frame_length);
        misc[3] = pitch_used[nb_subfr - 1];
    } else {
        plc_conceal(plc_i32, plc_i16, misc, exc_Q14_state, outBuf,
                    sLPC_Q14_buf, frame_length, subfr_length, nb_subfr,
                    lpc_order, ltp_mem_length, fs_khz, pitch_used, xq);
        misc[0] += 1;
        int mv_len = ltp_mem_length - frame_length;
        memmove(outBuf, &outBuf[frame_length], mv_len * sizeof(int16_t));
        memcpy(&outBuf[mv_len], xq, frame_length * sizeof(int16_t));
        cng_frame(cng_i32, cng_i16, plc_i32, plc_i16, misc,
                  prevNLSF_Q15, exc_Q14_state, Gains_Q16, cos_tab,
                  signalTypeInd, nb_subfr, subfr_length, lpc_order,
                  fs_khz, xq, frame_length);
        plc_glue(plc_i32, misc, xq, frame_length);
        misc[3] = pitch_used[nb_subfr - 1];
    }
    return 0;
}

}  // extern "C"
