// Parametric-stereo (HE-AAC v2) decorrelator and mixer over a group's QMF
// slots, for Hopper (sm_90a).
//
// Replaces the step and scan of `ps_decorrelate_mix` in
// ohpipeline_tpu/codecs/aac/sbr_jax.py:1149-1237 (a `lax.scan` over the
// slots, carrying the power states, the delay lines and the all-pass
// rings).  Its plain version is `ps_scan_torch` in
// ohpipeline_tpu_torch/codecs/aac/sbr.py, whose layouts PS_CARRY, PS_COEF
// and PS_IMAP the offsets below mirror.  Per stream and slot, over 73
// channels (12 hybrid subbands, then QMF bands 3-63; x = mr + i mi):
//   p[g]  = sum over group g's members, in channel order, of xr^2 + xi^2;
//   pd    = max(pd * PK, p);  ppd += IC * ((pd - p) - ppd);
//   pnrg  = max(pnrg + IC * (p - pnrg), 0);  nrg = pnrg * TI;
//   trans = ppd <= nrg ? 1 : nrg / max(ppd, 1e-30);
//   channels 0-31 (all-pass): r0 = x(t - 2) * phi; res = dsf * r0; then per
//     link m (rings of 3, 4, 5 slots): tr = ring_m.oldest * ser_m - dser_m *
//     res; res = dsf * tr; ring_m.push(r0 + dser_m * res); r0 = tr;  d = r0;
//   channels 32-72 (plain delays): d = the 14-deep ring at offset loff;
//     ring.push(x);
//   d *= trans[tgrp]; L = (h11 x + h21 d) * mask; R = (h12 x + h22 d) * mask,
//   with h the slot's matrix of the channel's mixing group.
// Every product, sum and quotient is rounded on its own (no fused multiply-
// add), in the plain version's order, so the two agree bit for bit.
//
// What bounds it on this card: its bytes are few (a 3072-slot group moves
// ~6.5 MB, ~2 us at 3.35 TB/s) and its operations fewer; the floor is the
// chain, S slots one after another through the power recurrence and each
// channel's all-pass links.  The simple design here: one block per stream,
// walking the slots in chunks of 32.  A chunk's input slots and mixing
// matrices are staged in shared memory with coalesced loads; all threads sum
// the (group, slot) powers; 20 threads walk the chunk's power recurrence and
// leave its transient factors in shared memory; then one thread per channel
// walks the chunk's slots through its delay, all-pass links (rings in shared
// memory, one column per thread) and mix, storing L and R coalesced.  Four
// barriers a chunk, none a slot; the recurrence and the channel walks of a
// chunk do not overlap.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 73;                  // channels of a slot
constexpr int kAp = 32;                  // all-pass channels
constexpr int kLong = kCh - kAp;         // plain-delay channels
constexpr int kGroups = 20;              // power / transient groups
constexpr int kMix = 22;                 // mixing groups
constexpr int kMaxMem = 29;              // channels of the widest group
constexpr int kLng = 14;                 // long-delay ring depth
constexpr int kRing = 3 + 4 + 5;         // slots of the three all-pass rings
constexpr int kChunk = 32;               // slots staged at a time
constexpr int kThreads = 128;

// carry (PS_CARRY): pow (3, 20), d2 re / im (2, 32), the rings re / im
// (32, 3), (32, 4), (32, 5), the long delays re / im (41, 14); rings oldest
// slot first
constexpr int kPow = 0;
constexpr int kD2Re = kPow + 3 * kGroups;
constexpr int kD2Im = kD2Re + 2 * kAp;
constexpr int kR3Re = kD2Im + 2 * kAp;
constexpr int kR3Im = kR3Re + 3 * kAp;
constexpr int kR4Re = kR3Im + 3 * kAp;
constexpr int kR4Im = kR4Re + 4 * kAp;
constexpr int kR5Re = kR4Im + 4 * kAp;
constexpr int kR5Im = kR5Re + 5 * kAp;
constexpr int kLngRe = kR5Im + 5 * kAp;
constexpr int kLngIm = kLngRe + kLng * kLong;
constexpr int kCarry = kLngIm + kLng * kLong;
static_assert(kCarry == 2104, "PS_CARRY layout");
// coef (PS_COEF): phi re / im (32), ser re / im (32, 3), dsf (32), dser
// (3), PK IC TI, mask (73)
constexpr int kPhiRe = 0;
constexpr int kPhiIm = kPhiRe + kAp;
constexpr int kSerRe = kPhiIm + kAp;
constexpr int kSerIm = kSerRe + 3 * kAp;
constexpr int kDsf = kSerIm + 3 * kAp;
constexpr int kDser = kDsf + kAp;
constexpr int kConst = kDser + 3;
constexpr int kMask = kConst + 3;
static_assert(kMask + kCh == 367, "PS_COEF layout");
// imap (PS_IMAP): members (20, 29), their counts (20), per channel its
// transient and mixing group (73 each), per long channel its ring offset
constexpr int kMembers = 0;
constexpr int kNmem = kMembers + kGroups * kMaxMem;
constexpr int kTgrp = kNmem + kGroups;
constexpr int kMgrp = kTgrp + kCh;
constexpr int kLoff = kMgrp + kCh;
static_assert(kLoff + kLong == 787, "PS_IMAP layout");

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

__global__ void __launch_bounds__(kThreads)
ps_mix_scan(const float* __restrict__ mr, const float* __restrict__ mi,
            const float* __restrict__ H, const float* __restrict__ carry_in,
            const float* __restrict__ coef, const int* __restrict__ imap,
            float* __restrict__ Lr, float* __restrict__ Li,
            float* __restrict__ Rr, float* __restrict__ Ri,
            float* __restrict__ carry_out, int S) {
  __shared__ float s_xr[kChunk][kCh];
  __shared__ float s_xi[kChunk][kCh];
  __shared__ float s_h[kChunk][4 * kMix];
  __shared__ float s_tr[kChunk][kGroups];   // powers, then transient factors
  __shared__ float s_ap[2][kRing][kAp];     // all-pass rings, re and im
  __shared__ float s_lng[2][kLng][kLong];   // long-delay rings, re and im

  const int tid = threadIdx.x;
  const int64_t slot0 = static_cast<int64_t>(blockIdx.x) * S;
  const float* cin = carry_in + static_cast<int64_t>(blockIdx.x) * kCarry;
  float* cout = carry_out + static_cast<int64_t>(blockIdx.x) * kCarry;
  const bool is_grp = tid < kGroups, is_ch = tid < kCh, is_ap = tid < kAp;
  const int l = tid - kAp;                  // long channel index

  const float pk = coef[kConst], ic = coef[kConst + 1],
              ti = coef[kConst + 2];
  float pd = 0.0f, ppd = 0.0f, pnrg = 0.0f;
  if (is_grp) {
    pd = cin[kPow + tid];
    ppd = cin[kPow + kGroups + tid];
    pnrg = cin[kPow + 2 * kGroups + tid];
  }
  float phr = 0.0f, phi = 0.0f, dsf = 0.0f, mask = 0.0f;
  float ser_r[3], ser_i[3], dser[3];
  float d2ar = 0.0f, d2ai = 0.0f, d2br = 0.0f, d2bi = 0.0f;
  int tg = 0, mg = 0, loff = 0;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    dser[m] = coef[kDser + m];
    ser_r[m] = ser_i[m] = 0.0f;
  }
  if (is_ap) {
    phr = coef[kPhiRe + tid];
    phi = coef[kPhiIm + tid];
    dsf = coef[kDsf + tid];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      ser_r[m] = coef[kSerRe + 3 * tid + m];
      ser_i[m] = coef[kSerIm + 3 * tid + m];
    }
    d2ar = cin[kD2Re + tid];
    d2br = cin[kD2Re + kAp + tid];
    d2ai = cin[kD2Im + tid];
    d2bi = cin[kD2Im + kAp + tid];
    for (int j = 0; j < 3; ++j) {
      s_ap[0][j][tid] = cin[kR3Re + 3 * tid + j];
      s_ap[1][j][tid] = cin[kR3Im + 3 * tid + j];
    }
    for (int j = 0; j < 4; ++j) {
      s_ap[0][3 + j][tid] = cin[kR4Re + 4 * tid + j];
      s_ap[1][3 + j][tid] = cin[kR4Im + 4 * tid + j];
    }
    for (int j = 0; j < 5; ++j) {
      s_ap[0][7 + j][tid] = cin[kR5Re + 5 * tid + j];
      s_ap[1][7 + j][tid] = cin[kR5Im + 5 * tid + j];
    }
  } else if (is_ch) {
    loff = imap[kLoff + l];
    for (int j = 0; j < kLng; ++j) {
      s_lng[0][j][l] = cin[kLngRe + kLng * l + j];
      s_lng[1][j][l] = cin[kLngIm + kLng * l + j];
    }
  }
  if (is_ch) {
    mask = coef[kMask + tid];
    tg = imap[kTgrp + tid];
    mg = imap[kMgrp + tid];
  }
  int p3 = 0, p4 = 0, p5 = 0, pl = 0;       // each ring's oldest slot

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    const int64_t row0 = slot0 + t0;
    __syncthreads();                        // the last chunk is done
    for (int k = tid; k < n * kCh; k += kThreads) {
      (&s_xr[0][0])[k] = mr[row0 * kCh + k];
      (&s_xi[0][0])[k] = mi[row0 * kCh + k];
    }
    for (int k = tid; k < n * 4 * kMix; k += kThreads)
      (&s_h[0][0])[k] = H[row0 * (4 * kMix) + k];
    __syncthreads();

    // group powers, (group, slot) pairs group-major so a warp's pairs
    // share a member count
    for (int k = tid; k < kGroups * n; k += kThreads) {
      const int g = k / n, t = k - g * n;
      const int cnt = __ldg(imap + kNmem + g);
      float acc = 0.0f;
      for (int j = 0; j < cnt; ++j) {
        const int c = __ldg(imap + kMembers + kMaxMem * g + j);
        const float x = s_xr[t][c], y = s_xi[t][c];
        acc = add(acc, add(mul(x, x), mul(y, y)));
      }
      s_tr[t][g] = acc;
    }
    __syncthreads();

    if (is_grp) {                           // the power recurrence
      for (int t = 0; t < n; ++t) {
        const float p = s_tr[t][tid];
        pd = fmaxf(mul(pd, pk), p);
        ppd = add(ppd, mul(ic, sub(sub(pd, p), ppd)));
        pnrg = fmaxf(add(pnrg, mul(ic, sub(p, pnrg))), 0.0f);
        const float nrg = mul(pnrg, ti);
        s_tr[t][tid] = ppd <= nrg ? 1.0f
                                  : __fdiv_rn(nrg, fmaxf(ppd, 1e-30f));
      }
    }
    __syncthreads();

    if (is_ch) {                            // decorrelate and mix
      for (int t = 0; t < n; ++t) {
        const float xr = s_xr[t][tid], xi = s_xi[t][tid];
        float dr, di;
        if (is_ap) {
          float r0r = sub(mul(d2ar, phr), mul(d2ai, phi));
          float r0i = add(mul(d2ar, phi), mul(d2ai, phr));
          d2ar = d2br;
          d2ai = d2bi;
          d2br = xr;
          d2bi = xi;
          float res_r = mul(dsf, r0r), res_i = mul(dsf, r0i);
          const int at[3] = {p3, 3 + p4, 7 + p5};
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            const float sr = s_ap[0][at[m]][tid], si = s_ap[1][at[m]][tid];
            const float tr = sub(sub(mul(sr, ser_r[m]), mul(si, ser_i[m])),
                                 mul(dser[m], res_r));
            const float tq = sub(add(mul(sr, ser_i[m]), mul(si, ser_r[m])),
                                 mul(dser[m], res_i));
            res_r = mul(dsf, tr);
            res_i = mul(dsf, tq);
            s_ap[0][at[m]][tid] = add(r0r, mul(dser[m], res_r));
            s_ap[1][at[m]][tid] = add(r0i, mul(dser[m], res_i));
            r0r = tr;
            r0i = tq;
          }
          dr = r0r;
          di = r0i;
        } else {
          const int rd = pl + loff < kLng ? pl + loff : pl + loff - kLng;
          dr = s_lng[0][rd][l];
          di = s_lng[1][rd][l];
          s_lng[0][pl][l] = xr;
          s_lng[1][pl][l] = xi;
        }
        const float tc = s_tr[t][tg];
        dr = mul(dr, tc);
        di = mul(di, tc);
        const float h11 = s_h[t][mg], h12 = s_h[t][kMix + mg],
                    h21 = s_h[t][2 * kMix + mg], h22 = s_h[t][3 * kMix + mg];
        const int64_t o = (row0 + t) * kCh + tid;
        Lr[o] = mul(add(mul(h11, xr), mul(h21, dr)), mask);
        Li[o] = mul(add(mul(h11, xi), mul(h21, di)), mask);
        Rr[o] = mul(add(mul(h12, xr), mul(h22, dr)), mask);
        Ri[o] = mul(add(mul(h12, xi), mul(h22, di)), mask);
        p3 = p3 == 2 ? 0 : p3 + 1;
        p4 = p4 == 3 ? 0 : p4 + 1;
        p5 = p5 == 4 ? 0 : p5 + 1;
        pl = pl == kLng - 1 ? 0 : pl + 1;
      }
    }
  }

  // the carry out, rings oldest slot first
  if (is_grp) {
    cout[kPow + tid] = pd;
    cout[kPow + kGroups + tid] = ppd;
    cout[kPow + 2 * kGroups + tid] = pnrg;
  }
  if (is_ap) {
    cout[kD2Re + tid] = d2ar;
    cout[kD2Re + kAp + tid] = d2br;
    cout[kD2Im + tid] = d2ai;
    cout[kD2Im + kAp + tid] = d2bi;
    for (int j = 0; j < 3; ++j) {
      const int r = (p3 + j) % 3;
      cout[kR3Re + 3 * tid + j] = s_ap[0][r][tid];
      cout[kR3Im + 3 * tid + j] = s_ap[1][r][tid];
    }
    for (int j = 0; j < 4; ++j) {
      const int r = 3 + (p4 + j) % 4;
      cout[kR4Re + 4 * tid + j] = s_ap[0][r][tid];
      cout[kR4Im + 4 * tid + j] = s_ap[1][r][tid];
    }
    for (int j = 0; j < 5; ++j) {
      const int r = 7 + (p5 + j) % 5;
      cout[kR5Re + 5 * tid + j] = s_ap[0][r][tid];
      cout[kR5Im + 5 * tid + j] = s_ap[1][r][tid];
    }
  } else if (is_ch) {
    for (int j = 0; j < kLng; ++j) {
      const int r = (pl + j) % kLng;
      cout[kLngRe + kLng * l + j] = s_lng[0][r][l];
      cout[kLngIm + kLng * l + j] = s_lng[1][r][l];
    }
  }
}

}  // namespace

extern "C" int ohp_ps_mix(const float* mr, const float* mi, const float* H,
                          const float* carry_in, const float* coef,
                          const int* imap, float* Lr, float* Li, float* Rr,
                          float* Ri, float* carry_out, int C, int S,
                          cudaStream_t stream) {
  if (C > 0 && S > 0)
    ps_mix_scan<<<C, kThreads, 0, stream>>>(mr, mi, H, carry_in, coef, imap,
                                            Lr, Li, Rr, Ri, carry_out, S);
  return static_cast<int>(cudaGetLastError());
}
