// The AAC serving call's side rows, in the same library as the unpacker
// it builds on (this file includes aac_unpack.cc, which stays a byte copy
// of the JAX package's).
//
// A side row is a (frame, channel) row that aac_prepare_rows_zz hands back
// as special: one with a PNS or intensity band, which the zigzag wire
// cannot carry.  For each frame of one stream's group that holds a special
// row, both channels' float64 spectra are computed as
// synthesis.prepare_group computes them over the sub-batch of those
// frames: dequantisation (|q|^(4/3) and the scalefactor gains, looked up
// in tables numpy fills), PNS, M/S with prepare_group's band selection,
// intensity, and TNS with aac_tns_group.  The special rows are written as
// float32.
//
// The PNS noise is numpy's (synthesis._pns_noise): aac_side_draws lists
// each noise row's seed, first position and length, the caller draws them
// into one float64 buffer, and aac_side_rows scales them band by band.
//
// Nothing is kept from call to call but the constant tables.

#include <algorithm>
#include <vector>

#include "aac_unpack.cc"

namespace {

constexpr int CB_NOISE = 13, CB_IS2 = 14, CB_IS = 15;

// |q|^(4/3) for q < 8192 (synthesis._POW43), and over the scalefactors
// [-g_sf_off, g_sf_off): the dequantisation gains exp2(0.25 * (sf - 100)),
// the PNS band energies 2 ** (0.25 * sf) and the intensity scales
// 0.5 ** (0.25 * sf), each computed by numpy as prepare_group computes it
const double* g_pow43 = nullptr;
const double* g_gain = nullptr;
const double* g_energy = nullptr;
const double* g_is = nullptr;
int g_sf_off = 0;

inline double sf_table(const double* tab, int sf, double base, double mul,
                        double add) {
    if (sf >= -g_sf_off && sf < g_sf_off) return tab[sf + g_sf_off];
    return std::pow(base, mul * (sf + add));
}

// synthesis._layout of one row: the transmission position, spectral
// position and band slot (g * 15 + k) of each coefficient its bands hold,
// in transmission order.  Returns the count.
int side_layout(const int32_t* ics_row, int ri, int32_t* src, int32_t* dst,
                int32_t* band) {
    int seq = ics_row[0], max_sfb = ics_row[2], grouping = ics_row[3];
    bool shortw = seq == 2;
    const int16_t* off = shortw ? g_sfb_short[ri] : g_sfb_long[ri];
    int nb = g_nsfb[ri][shortw ? 1 : 0];
    if (max_sfb > nb) max_sfb = nb;
    int n = 0;
    if (!shortw) {
        for (int k = 0; k < max_sfb; k++)
            for (int i = off[k]; i < off[k + 1]; i++) {
                src[n] = dst[n] = i;
                band[n++] = k;
            }
        return n;
    }
    int group_wins[8] = {1, 0, 0, 0, 0, 0, 0, 0};
    int gi = 0;
    for (int b = 6; b >= 0; b--) {
        if ((grouping >> b) & 1) group_wins[gi]++;
        else group_wins[++gi] = 1;
    }
    int pos = 0, win_base = 0;
    for (int g = 0; g <= gi; g++) {
        for (int k = 0; k < max_sfb; k++) {
            int width = off[k + 1] - off[k];
            for (int w = 0; w < group_wins[g]; w++) {
                int a = (win_base + w) * 128 + off[k];
                for (int j = 0; j < width; j++) {
                    src[n] = pos + j;
                    dst[n] = a + j;
                    band[n++] = g * 15 + k;
                }
                pos += width;
            }
        }
        win_base += group_wins[g];
        pos = win_base * 128;
    }
    return n;
}

struct Layout {
    int32_t src[1024], dst[1024], band[1024];
    int n;
    Layout(const int32_t* ics_row, int ri)
        : n(side_layout(ics_row, ri, src, dst, band)) {}
};

// numpy's pairwise sum of float64 (np.add.reduce from 0.0); out of line,
// so no product is fused into its adds
__attribute__((noinline)) double pairwise_sum(const double* a, int n) {
    if (n < 8) {
        double r = 0.0;
        for (int i = 0; i < n; i++) r += a[i];
        return r;
    }
    if (n <= 128) {
        double r[8];
        for (int j = 0; j < 8; j++) r[j] = a[j];
        int i = 8;
        for (; i < n - n % 8; i += 8)
            for (int j = 0; j < 8; j++) r[j] += a[i + j];
        double s = ((r[0] + r[1]) + (r[2] + r[3]))
            + ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; i++) s += a[i];
        return s;
    }
    int n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// The frames that hold a special row, ascending and once each
// (np.unique(special // C)).
std::vector<int> side_frames(const int32_t* special, int nspecial, int C) {
    std::vector<int> fr(nspecial);
    for (int i = 0; i < nspecial; i++) fr[i] = special[i] / C;
    std::sort(fr.begin(), fr.end());
    fr.erase(std::unique(fr.begin(), fr.end()), fr.end());
    return fr;
}

inline bool has_cb(const int8_t* cbr, int lo, int hi) {
    for (int k = 0; k < SFB_SLOTS; k++)
        if (cbr[k] >= lo && cbr[k] <= hi) return true;
    return false;
}

// One row's dequantised spectrum: coded bands only, the rest zero.
void side_dequant(const Layout& L, const int8_t* cbr, const int32_t* sfr,
                  const int32_t* q, double* spec) {
    for (int i = 0; i < L.n; i++) {
        int b = L.band[i];
        int cbv = cbr[b];
        int32_t v = q[L.src[i]];
        int64_t a = v < 0 ? -(int64_t)v : v;
        double mag = a < 8192 ? g_pow43[a] : std::pow((double)a, 4.0 / 3.0);
        double dq = (double)((v > 0) - (v < 0)) * mag;
        double x = dq * sf_table(g_gain, sfr[b], 2.0, 0.25, -100.0);
        spec[L.dst[i]] = x * ((cbv >= 1 && cbv <= 11) ? 1.0 : 0.0);
    }
}

// One row's PNS bands from its drawn noise: each band slot scaled to the
// energy 2^(sf/4) over its coefficients.  Returns the noise used, or -1
// where the row needs more than the avail values left.
int side_noise(const Layout& L, const int8_t* cbr, const int32_t* sfr,
               const double* noise, int64_t avail, double* spec) {
    int need = 0;
    for (int i = 0; i < L.n; i++) need += cbr[L.band[i]] == CB_NOISE;
    if (need > avail) return -1;
    double seg[1024], sq[1024];
    int used = 0;
    int i = 0;
    while (i < L.n) {
        int b = L.band[i];
        int j = i;
        while (j < L.n && L.band[j] == b) j++;
        if (cbr[b] == CB_NOISE) {
            int m = j - i;
            for (int t = 0; t < m; t++) {
                seg[t] = noise[used + t];
                sq[t] = seg[t] * seg[t];
            }
            double mean = pairwise_sum(sq, m) / m;
            double e = sf_table(g_energy, sfr[b], 2.0, 0.25, 0.0);
            double scale = e / std::sqrt(mean + 1e-30);
            for (int t = 0; t < m; t++) spec[L.dst[i + t]] = seg[t] * scale;
            used += m;
        }
        i = j;
    }
    return used;
}

// M/S and intensity of one channel pair, in the left channel's layout.
void side_pair(const Layout& L, const uint8_t* ms, const int8_t* cbr,
               const int32_t* sfr, double* left, double* right) {
    uint8_t flag = ms[0];
    if ((flag == 0 || flag == 0xFF) && !has_cb(cbr, CB_IS2, CB_IS)) return;
    auto masked = [&](int b) {
        return flag == 2 || (flag == 1 && ms[1 + b] != 0);
    };
    if (flag == 1 || flag == 2) {
        for (int i = 0; i < L.n; i++) {
            int b = L.band[i], c = cbr[b];
            if (!masked(b) || c == CB_IS || c == CB_IS2 || c == CB_NOISE)
                continue;
            int d = L.dst[i];
            double mid = left[d], side = right[d];
            left[d] = mid + side;
            right[d] = mid - side;
        }
    }
    for (int i = 0; i < L.n; i++) {
        int b = L.band[i], c = cbr[b];
        if (c != CB_IS && c != CB_IS2) continue;
        double sign = (c == CB_IS ? 1.0 : -1.0) * (masked(b) ? -1.0 : 1.0);
        double scale = sign * sf_table(g_is, sfr[b], 0.5, 0.25, 0.0);
        right[L.dst[i]] = left[L.dst[i]] * scale;
    }
}

}  // namespace

extern "C" {

void aac_side_set_tables(const double* pow43, const double* gain,
                         const double* energy, const double* is, int off) {
    g_pow43 = pow43;
    g_gain = gain;
    g_energy = energy;
    g_is = is;
    g_sf_off = off;
}

// The PNS draws of one stream's group's side rows: per noise row of the
// special frames' sub-batch, in order, (row, pos, n) into draws (room for
// C per special row): row = the frame's rank among the special frames
// times C plus the channel, pos the spectral position of its first noise
// coefficient in transmission order, n its noise coefficients.  Returns
// the count of draws.
int aac_side_draws(const int32_t* ics, const int8_t* cb, int rate_index,
                   int C, const int32_t* special, int nspecial,
                   int32_t* draws) {
    std::vector<int> frames = side_frames(special, nspecial, C);
    int nd = 0;
    for (size_t j = 0; j < frames.size(); j++)
        for (int c = 0; c < C; c++) {
            int r = frames[j] * C + c;
            const int8_t* cbr = cb + (int64_t)r * SFB_SLOTS;
            if (!has_cb(cbr, CB_NOISE, CB_NOISE)) continue;
            Layout L(&ics[r * 4], rate_index);
            int n = 0, pos = -1;
            for (int i = 0; i < L.n; i++)
                if (cbr[L.band[i]] == CB_NOISE) {
                    if (pos < 0) pos = L.dst[i];
                    n++;
                }
            if (n == 0) continue;
            draws[nd * 3] = (int32_t)j * C + c;
            draws[nd * 3 + 1] = pos;
            draws[nd * 3 + 2] = n;
            nd++;
        }
    return nd;
}

// The side rows of one stream's group: special[i] = f * C + c (rows of
// the parse buffer) written to side[i] (float32 x 1024) and
// srow[i] = f * SC + col0 + c.  noise holds the draws aac_side_draws
// listed, one after another (nnoise in all).  Returns 0, or -1 when the
// noise does not match the draws.
int aac_side_rows(const int32_t* ics, const int8_t* cb, const int32_t* sf,
                  const int32_t* quant, const uint8_t* msmask,
                  const int32_t* tnsn, const int32_t* tnsp,
                  const float* tnsc, int rate_index, int C,
                  const int32_t* special, int nspecial,
                  const double* noise, int64_t nnoise, int SC, int col0,
                  float* side, int32_t* srow) {
    std::vector<int> frames = side_frames(special, nspecial, C);
    std::vector<double> specs(frames.size() * C * 1024, 0.0);
    int64_t used = 0;
    for (size_t j = 0; j < frames.size(); j++) {
        int f = frames[j];
        double* fs = &specs[j * C * 1024];
        for (int c = 0; c < C; c++) {
            int r = f * C + c;
            const int8_t* cbr = cb + (int64_t)r * SFB_SLOTS;
            const int32_t* sfr = sf + (int64_t)r * SFB_SLOTS;
            Layout L(&ics[r * 4], rate_index);
            side_dequant(L, cbr, sfr, quant + (int64_t)r * 1024,
                         fs + c * 1024);
            int n = side_noise(L, cbr, sfr, noise + used, nnoise - used,
                               fs + c * 1024);
            if (n < 0) return -1;
            used += n;
        }
        if (C == 2) {
            int rl = f * 2;
            Layout L(&ics[rl * 4], rate_index);
            side_pair(L, msmask + (int64_t)f * SFB_SLOTS,
                      cb + (int64_t)(rl + 1) * SFB_SLOTS,
                      sf + (int64_t)(rl + 1) * SFB_SLOTS, fs, fs + 1024);
        }
        int r0 = f * C;
        aac_tns_group(fs, C, ics + r0 * 4, tnsn + r0 * 8, tnsp + r0 * 72,
                      tnsc + (int64_t)r0 * 288, rate_index);
    }
    if (used != nnoise) return -1;
    for (int i = 0; i < nspecial; i++) {
        int f = special[i] / C, c = special[i] % C;
        size_t j = std::lower_bound(frames.begin(), frames.end(), f)
            - frames.begin();
        const double* row = &specs[(j * C + c) * 1024];
        for (int k = 0; k < 1024; k++) side[(int64_t)i * 1024 + k] =
            (float)row[k];
        srow[i] = f * SC + col0 + c;
    }
    return 0;
}

}  // extern "C"
