// The HE-AAC serving call's host SBR chain over dense arrays, in the same
// library as the payload parser it builds on (this file includes
// sbr_parse.cc, which stays a byte copy of the JAX package's).
//
// sbr_chain_parse: one stream's SBR payloads of a group, read from the
// planes the AAC unpacker captures (a row of bytes, the bit count and
// the CRC flag a frame).  Per frame: the CRC skipped, the header flag
// and the header's fields read (held to the call's one header), the
// sbr_data() parse of sbr_parse_payload with the stream's delta-coding
// state carried in arrays, and the envelope and noise levels dequantised
// in float64, with the channel-pair unmapping when coupling is set.
// Mirrors sbr.py's SbrDecoder.parse_payload, dequant and unmap_coupled
// as sbr_chain.sbr_frames chains them; the exponentials are looked up in
// tables the loader fills with numpy's exp2, so every level is the one
// the numpy chain computes.  It declines (returns 0, nothing committed)
// wherever that chain would raise or take another path: the caller then
// raises.
//
// sbr_chain_cond: the SBR cond planes of a group's channels
// (sbr_host.SbrFrameCond, stacked over channels) filled from those
// arrays, with each channel's host state (inverse-filtering modes, chirp
// factors, noise and sine counters, harmonic bins, transient envelope)
// advanced as sbr_host.build_frame_cond advances it.
//
// Built with -ffp-contract=off: the chirp recurrence and the unmapping
// must round as numpy rounds each product and sum.

#include "sbr_parse.cc"

namespace {

constexpr int C_MAXE = 8;      // sbr_host.MAXE: envelope slots a frame
constexpr int C_NSL = 38;      // sbr_host.NSL: buffered QMF slots a frame
constexpr int C_NHDR = 11;     // SbrHeader's fields, in declaration order
constexpr int C_GRID = 32;     // grid row, sbr_parse_payload's layout
// delta-coding state of one stream, sbr_parse_payload's prev_* inputs:
// env rows [2][MAXB], env lengths [2], freq_res [2], noise rows
// [2][MAXQ], noise present [2]
constexpr int P_ENV = 0, P_LEN = 2 * MAXB, P_RES = P_LEN + 2,
              P_NOISE = P_RES + 2, P_HAVE = P_NOISE + 2 * MAXQ,
              P_SIZE = P_HAVE + 2;

// exp2 tables over the integer levels [-g_off, g_off): envelope levels at
// a = 1 and a = 2 (times 64 * ENERGY_CAL), noise levels, and the balance
// factors of the unmapping at a = 1, a = 2 and for noise
const double* g_tab[6] = {nullptr};
int g_off = 0;

// SbrHeader defaults for the fields a header may leave out
bool read_header(Bits& b, int32_t* h) {
    static const int32_t defaults[C_NHDR] = {1, 5, 0, 0, 2, 1, 2, 2, 2, 1, 1};
    for (int i = 0; i < C_NHDR; i++) h[i] = defaults[i];
    h[0] = b.read(1);
    h[1] = b.read(4);
    h[2] = b.read(4);
    h[3] = b.read(3);
    b.read(2);
    int extra1 = b.read(1);
    int extra2 = b.read(1);
    if (extra1) {
        h[4] = b.read(2);
        h[5] = b.read(1);
        h[6] = b.read(2);
    }
    if (extra2) {
        h[7] = b.read(2);
        h[8] = b.read(2);
        h[9] = b.read(1);
        h[10] = b.read(1);
    }
    return b.ok;
}

inline bool level(const double* tab, int v, double& out) {
    if (v < -g_off || v >= g_off) return false;
    out = tab[v + g_off];
    return true;
}

// sbr.map_invf_bw for one band
inline double invf_bw(int m, int pm) {
    if (m == 1) return pm == 0 ? 0.6 : 0.75;
    if (m == 2) return 0.90;
    if (m == 3) return 0.98;
    return pm == 1 ? 0.6 : 0.0;
}

}  // namespace

extern "C" {

void sbr_chain_set_tables(const double* e1, const double* e2,
                          const double* q, const double* b1,
                          const double* b2, const double* bq, int off) {
    g_tab[0] = e1; g_tab[1] = e2; g_tab[2] = q;
    g_tab[3] = b1; g_tab[4] = b2; g_tab[5] = bq;
    g_off = off;
}

// One stream's n frames of a group.  hdr: the call's header (C_NHDR
// fields); have_hdr: the stream has had it before this group.  pstate
// (P_SIZE ints) is read and, on success only, advanced.  Outputs per
// channel c and frame f, channel-major over G frames: grid[c][f][32]
// (sbr_parse_payload's layout), E[c][f][MAXENV][NB] and Q[c][f][2][NQ]
// float64 levels, invf[c][f][NQ], harm[c][f][NB].  Returns 1, or 0
// where it declines the group.
int sbr_chain_parse(
    const uint8_t* bytes, int64_t stride, const int32_t* nbits,
    const int32_t* crc, int n, int stereo, const int32_t* hdr, int have_hdr,
    int n_q, int n_low, int n_high,
    const int32_t* idx_h2l, const int32_t* idx_l2h,
    int32_t* pstate, int G, int NB, int NQ,
    int32_t* grid, double* E, double* Q, int32_t* invf, uint8_t* harm) {
    if (g_off <= 0 || n_q > MAXQ || n_q > NQ || n_high > NB
        || n_low > NB || NB > MAXB || n > G)
        return 0;
    const int nch = stereo ? 2 : 1;
    int32_t st[P_SIZE];
    memcpy(st, pstate, sizeof st);
    int32_t go[2 * C_GRID], dfe[2 * MAXENV], dfn[2 * 2], inv[2 * MAXQ];
    int32_t env[2 * MAXENV * MAXB], noi[2 * 2 * MAXQ], ah[2 * MAXB];
    int64_t ps[2];
    int32_t cpl = 0;
    bool hdr_ok = have_hdr != 0;
    for (int f = 0; f < n; f++) {
        if (nbits[f] <= 0) return 0;                   // no payload
        const uint8_t* buf = bytes + (int64_t)f * stride;
        Bits b{buf, 0, nbits[f]};
        if (crc[f]) b.read(10);
        if (b.read(1)) {                               // bs_header_flag
            int32_t h[C_NHDR];
            if (!read_header(b, h)) return 0;
            for (int i = 0; i < C_NHDR; i++)
                if (h[i] != hdr[i]) return 0;
            hdr_ok = true;
        }
        if (!b.ok || !hdr_ok) return 0;
        memset(go, 0, sizeof go);
        if (!sbr_parse_payload(buf, nbits[f], b.pos, stereo, hdr[0], n_q,
                               n_low, n_high, idx_h2l, idx_l2h,
                               st + P_ENV, st + P_LEN, st + P_RES,
                               st + P_NOISE, st + P_HAVE, go, dfe, dfn, inv,
                               env, noi, ah, ps, &cpl))
            return 0;
        if (ps[0] >= 0) return 0;                      // parametric stereo
        const bool coupled = stereo && cpl;
        for (int c = 0; c < nch; c++) {
            const int32_t* g = go + c * C_GRID;
            // build_frame_cond reads t_env[e + 1] for every envelope
            if (g[5] < g[1] + 1) return 0;
            const int64_t row = (int64_t)c * G + f;
            memcpy(grid + row * C_GRID, g, sizeof(int32_t) * C_GRID);
            for (int q = 0; q < n_q; q++)
                invf[row * NQ + q] = inv[c * MAXQ + q];
            for (int k = 0; k < n_high; k++)
                harm[row * NB + k] = (uint8_t)(ah[c * MAXB + k] != 0);
            if (coupled && c == 1) continue;           // unmapped below
            const int amp = (g[0] == 0 && g[1] == 1) ? 0 : hdr[0];
            const double* te = g_tab[amp == 0 ? 1 : 0];
            for (int e = 0; e < g[1]; e++) {
                const int nb = g[25 + e] ? n_high : n_low;
                for (int k = 0; k < nb; k++)
                    if (!level(te, env[(c * MAXENV + e) * MAXB + k],
                               E[(row * MAXENV + e) * NB + k]))
                        return 0;
            }
            for (int e = 0; e < g[4]; e++)
                for (int k = 0; k < n_q; k++)
                    if (!level(g_tab[2], noi[(c * 2 + e) * MAXQ + k],
                               Q[(row * 2 + e) * NQ + k]))
                        return 0;
        }
        if (coupled) {
            // sbr.unmap_coupled: right = 2 L / (1 + b), left = b right,
            // with b from channel 1's raw balance levels
            const int32_t* g = go;
            const int amp = (g[0] == 0 && g[1] == 1) ? 0 : hdr[0];
            const double* tb = g_tab[amp == 0 ? 4 : 3];
            const int64_t r0 = f, r1 = (int64_t)G + f;
            for (int e = 0; e < g[1]; e++) {
                const int nb = g[25 + e] ? n_high : n_low;
                for (int k = 0; k < nb; k++) {
                    double bal;
                    if (!level(tb, env[(MAXENV + e) * MAXB + k], bal))
                        return 0;
                    double& e0 = E[(r0 * MAXENV + e) * NB + k];
                    const double r = 2.0 * e0 / (1.0 + bal);
                    E[(r1 * MAXENV + e) * NB + k] = r;
                    e0 = bal * r;
                }
            }
            for (int e = 0; e < g[4]; e++)
                for (int k = 0; k < n_q; k++) {
                    double bal;
                    if (!level(g_tab[5], noi[(2 + e) * MAXQ + k], bal))
                        return 0;
                    double& q0 = Q[(r0 * 2 + e) * NQ + k];
                    const double r = 2.0 * q0 / (1.0 + bal);
                    Q[(r1 * 2 + e) * NQ + k] = r;
                    q0 = bal * r;
                }
        }
        // the delta-coding state: each channel's last envelope and noise
        // rows (sbr.py's _parse_prev)
        for (int c = 0; c < nch; c++) {
            const int32_t* g = go + c * C_GRID;
            const int last = g[1] - 1;
            const int nb = g[25 + last] ? n_high : n_low;
            memcpy(st + P_ENV + c * MAXB, env + (c * MAXENV + last) * MAXB,
                   sizeof(int32_t) * nb);
            st[P_LEN + c] = nb;
            st[P_RES + c] = g[25 + last];
            memcpy(st + P_NOISE + c * MAXQ,
                   noi + (c * 2 + g[4] - 1) * MAXQ, sizeof(int32_t) * n_q);
            st[P_HAVE + c] = 1;
        }
    }
    memcpy(pstate, st, sizeof st);
    return 1;
}

// The cond planes of C channels over F frames.  nf[c]: channel c's
// frames in the parse arrays (0: none, a dead stream).  The planes
// arrive holding SbrFrameCond's defaults.  Static: the band tables of
// the call's header.  State per channel, advanced: prev_invf[5], bw[5],
// noise_index, sine_index, prev_harm[64] (a mask over bins), prev_tran,
// first.
void sbr_chain_cond(
    int C, int G, int NB, int NQ, const int32_t* nf,
    const int32_t* grid, const double* E, const double* Q,
    const int32_t* invf, const uint8_t* harm,
    int kx, int M, int n_high, int n_q, const int32_t* f_high,
    const int32_t* patch_qi, int nb_low, int nb_high, int nb_row,
    int nq_row, int smoothing_mode, const double* smooth,
    int64_t* prev_invf, double* bw, int64_t* noise_index,
    int64_t* sine_index, uint8_t* prev_harm, int32_t* prev_tran,
    uint8_t* first, int F,
    float* Erow, float* Qrow, float* fres, uint8_t* sine, float* no_noise,
    int8_t* env_id, int8_t* prev_id, float* r, float* last_env,
    int32_t* noise_idx0, int32_t* sine_ph0, float* bwk, float* carry_mask) {
    for (int c = 0; c < C; c++) {
        noise_idx0[c] = (int32_t)noise_index[c];
        sine_ph0[c] = (int32_t)sine_index[c];
        for (int f = 0; f < nf[c] && f < F; f++) {
            const int64_t row = (int64_t)c * G + f;
            const int64_t cf = (int64_t)c * F + f;
            const int32_t* g = grid + row * C_GRID;
            const int n_env = g[1], tran_env = g[3], n_noise = g[4];
            const int32_t* t_env = g + 6;
            const int32_t* t_noise = g + 22;
            const int32_t* freq_res = g + 25;
            // chirp factors (sbr.map_invf_bw and the bw recurrence)
            double nbw[5];
            for (int q = 0; q < n_q; q++) {
                const int m = invf[row * NQ + q];
                const double nbq = invf_bw(m, (int)prev_invf[c * 5 + q]);
                prev_invf[c * 5 + q] = m;
                const double pv = bw[c * 5 + q];
                double v = nbq < pv ? 0.75 * nbq + 0.25 * pv
                                    : 0.90625 * nbq + 0.09375 * pv;
                if (v < 0.015625) v = 0.0;
                nbw[q] = std::min(v, 0.99609375);
            }
            for (int q = 0; q < n_q; q++) bw[c * 5 + q] = nbw[q];
            for (int k = 0; k < 64; k++)
                bwk[cf * 64 + k] = (float)bw[c * 5 + patch_qi[k]];
            // sine bookkeeping
            int sine_start[64];
            uint8_t cur[64];
            for (int k = 0; k < 64; k++) { sine_start[k] = -1; cur[k] = 0; }
            for (int b = 0; b < n_high; b++) {
                if (!harm[row * NB + b]) continue;
                const int mid = (f_high[b] + f_high[b + 1]) / 2 - kx;
                if (0 <= mid && mid < M) {
                    cur[mid] = 1;
                    sine_start[mid] = prev_harm[c * 64 + mid]
                        ? 0 : std::max(tran_env, 0);
                }
            }
            const int prev_tr = prev_tran[c];
            memcpy(prev_harm + c * 64, cur, 64);
            prev_tran[c] = tran_env == n_env ? 0 : -1;
            const int cm = std::max(0, std::min(t_env[0] * 2, C_NSL));
            for (int s = 0; s < cm; s++) carry_mask[cf * C_NSL + s] = 1.0f;
            int last = -1;
            for (int e = 0; e < std::min(n_env, C_MAXE); e++) {
                const int sl0 = std::max(0, std::min(t_env[e] * 2, C_NSL));
                const int sl1 = std::max(sl0,
                                         std::min(t_env[e + 1] * 2, C_NSL));
                if (sl1 <= sl0) continue;
                const int fr = freq_res[e];
                const int nb = fr ? nb_high : nb_low;
                int ne = 0;
                for (int q = 0; q < n_noise; q++)
                    if (t_noise[q] <= t_env[e] && t_env[e] < t_noise[q + 1])
                        ne = q;
                const int64_t ce = cf * C_MAXE + e;
                fres[ce] = fr ? 1.0f : 0.0f;
                for (int k = 0; k < nb; k++)
                    Erow[ce * nb_row + k] =
                        (float)E[(row * MAXENV + e) * NB + k];
                for (int k = 0; k < nq_row; k++)
                    Qrow[ce * nq_row + k] = (float)Q[(row * 2 + ne) * NQ + k];
                for (int k = 0; k < M; k++)
                    sine[ce * M + k] =
                        sine_start[k] >= 0 && e >= sine_start[k];
                const bool nn = e == tran_env || e == prev_tr;
                no_noise[ce] = nn ? 1.0f : 0.0f;
                const int smooth_len = (nn || smoothing_mode) ? 0 : 4;
                const int src = last >= 0 ? last
                    : (first[c] && f == 0) ? e : C_MAXE;
                for (int s = sl0; s < sl1; s++) {
                    env_id[cf * C_NSL + s] = (int8_t)e;
                    if (s - sl0 < smooth_len)
                        r[cf * C_NSL + s] = (float)smooth[s - sl0];
                    prev_id[cf * C_NSL + s] = (int8_t)src;
                }
                const int nslots = sl1 - sl0;
                noise_index[c] = (noise_index[c] + (int64_t)nslots * M) & 511;
                sine_index[c] = (sine_index[c] + nslots) & 3;
                last = e;
            }
            if (last >= 0) last_env[cf * C_MAXE + last] = 1.0f;
        }
        first[c] = 0;
    }
}

}  // extern "C"
