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
//   channels 32-72 (plain delays): d = the 14-deep ring at offset loff, that
//     is x(t + loff - 14), or the carried ring's entry t + loff;
//   d *= trans[tgrp]; L = (h11 x + h21 d) * mask; R = (h12 x + h22 d) * mask,
//   with h the slot's matrix of the channel's mixing group.
// Every product, sum and quotient is rounded on its own (no fused multiply-
// add), in the plain version's order, so the two agree bit for bit.
//
// What bounds it on this card: its bytes are few (a 3072-slot group moves
// ~6.5 MB, ~2 us at 3.35 TB/s) and its operations fewer; the floor is the
// two true recurrences, S slots one after another: the 20 power chains (pd,
// ppd, pnrg) and the 32 all-pass channels' rings.  Everything else is a map
// over slots.  So the work is split by what is a recurrence, into three
// kernels launched back to back on the caller's stream:
//   1. ps_powers, a wide grid over (stream, slot, group): the group powers p
//      into scratch;
//   2. ps_chains, one block of five warps a stream.  Warps 2-3 walk the 32
//      all-pass channels over all slots, 16 channels a warp and a lane pair
//      a channel, one lane its re part and the other its im part: each lane
//      holds both parts of its channel's rings in registers and sends the
//      partner the value it pushes (__shfl_xor, 3 or more slots before it is
//      read), so a warp issues about half a channel's operations a slot.
//      The slot loop is unrolled over a chunk, so the rings' moves are
//      register renamings; d is stored before the transient factor.  Warp 4
//      walks the 20 power chains and stores (ppd, nrg) a slot, the compare
//      and division that make trans left to the mix.  Warps 0-1 stage both
//      walks' input, kChunk slots at a time, into kBufs shared buffers with
//      cp.async, kLag chunks ahead of the one handed over by named barriers,
//      so the chain warps read only shared memory; they issue from other
//      schedulers (warp i issues from scheduler i mod 4) than the all-pass
//      warps;
//   3. ps_mix_out, a wide grid over (stream, slot, channel): trans from
//      (ppd, nrg), the long channels' delay read straight from the input (or
//      the carried ring), the mix, coalesced stores; and the long rings'
//      carry.
// The scratch (p, ppd, nrg: (C, S, 20); d re / im: (C, S, 32)) is the
// caller's: a kernel allocates nothing.

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
constexpr int kChunk = 30;               // slots staged (and unrolled) at once
constexpr int kBufs = 4;                 // staging buffers
constexpr int kLag = kBufs - 2;          // chunks in flight past the next
constexpr int kChainThreads = 160;       // staging x2, all-pass x2, power
constexpr int kStagers = kChainThreads - 96;
constexpr int kMapThreads = 256;
// scratch floats a slot: p, ppd, nrg (20 each), d re and im (32 each)
constexpr int kScratch = 3 * kGroups + 2 * kAp;

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

// named barriers (0 is __syncthreads'): a buffer is full, a buffer is empty
constexpr int kFull = 1;
constexpr int kEmpty = kFull + kBufs;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kChainThreads)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(kChainThreads)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 1. group powers, one thread per (slot, group), (slot, group) pairs in
// p's order so the stores are coalesced
__global__ void __launch_bounds__(kMapThreads)
ps_powers(const float* __restrict__ mr, const float* __restrict__ mi,
          const int* __restrict__ imap, float* __restrict__ p, int S) {
  const int k = blockIdx.x * kMapThreads + threadIdx.x;
  if (k >= S * kGroups) return;
  const int t = k / kGroups, g = k - t * kGroups;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * S + t;
  const float* xr = mr + row * kCh;
  const float* xi = mi + row * kCh;
  const int cnt = __ldg(imap + kNmem + g);
  float acc = 0.0f;
  for (int j = 0; j < cnt; ++j) {
    const int c = __ldg(imap + kMembers + kMaxMem * g + j);
    const float x = __ldg(xr + c), y = __ldg(xi + c);
    acc = add(acc, add(mul(x, x), mul(y, y)));
  }
  p[row * kGroups + g] = acc;
}

// 2. the recurrences
struct Stage {
  float xr[kChunk][kAp];                 // the all-pass channels' input
  float xi[kChunk][kAp];
  float p[kChunk][kGroups];              // the group powers
};

// one all-pass link of one part (re or im) of a channel, the lane pair
// (re, im) holding both parts of the ring oldest first: own = the lane's
// part, other = its partner's.  tr_re = sr ser_r - si ser_i and tr_im =
// sr ser_i + si ser_r are both own * ser_r + other * e2 (e2 = -ser_i for re,
// ser_i for im: a - b is a + (-b) exactly, and the add commutes).
template <int D>
__device__ __forceinline__ void link(float (&ro)[D], float (&rx)[D],
                                     float ser_r, float e2, float dser,
                                     float dsf, float& r0, float& res) {
  const float t = sub(add(mul(ro[0], ser_r), mul(rx[0], e2)), mul(dser, res));
  res = mul(dsf, t);
  const float pushed = add(r0, mul(dser, res));
  const float partner = __shfl_xor_sync(0xffffffffu, pushed, 1);
#pragma unroll
  for (int q = 0; q + 1 < D; ++q) {
    ro[q] = ro[q + 1];
    rx[q] = rx[q + 1];
  }
  ro[D - 1] = pushed;
  rx[D - 1] = partner;
  r0 = t;
}

struct AllPass {
  float phr, c2, dsf, ser_r[3], e2[3], dser[3];
  float d2a, d2ax, d2b, d2bx;            // x(t - 2), x(t - 1): own, other
  float r3o[3], r3x[3], r4o[4], r4x[4], r5o[5], r5x[5];

  // one slot: x(t) in (own and other part), d(t)'s own part out
  __device__ __forceinline__ void step(float xo, float xx, float* d) {
    float r0 = add(mul(d2a, phr), mul(d2ax, c2));
    d2a = d2b;
    d2ax = d2bx;
    d2b = xo;
    d2bx = xx;
    float res = mul(dsf, r0);
    link<3>(r3o, r3x, ser_r[0], e2[0], dser[0], dsf, r0, res);
    link<4>(r4o, r4x, ser_r[1], e2[1], dser[1], dsf, r0, res);
    link<5>(r5o, r5x, ser_r[2], e2[2], dser[2], dsf, r0, res);
    *d = r0;
  }
};

__global__ void __launch_bounds__(kChainThreads)
ps_chains(const float* __restrict__ mr, const float* __restrict__ mi,
          const float* __restrict__ carry_in, const float* __restrict__ coef,
          const float* __restrict__ p, float* __restrict__ ppd_out,
          float* __restrict__ nrg_out, float* __restrict__ d_re,
          float* __restrict__ d_im, float* __restrict__ carry_out, int S) {
  __shared__ __align__(16) Stage st[kBufs];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t slot0 = static_cast<int64_t>(blockIdx.x) * S;
  const float* cin = carry_in + static_cast<int64_t>(blockIdx.x) * kCarry;
  float* cout = carry_out + static_cast<int64_t>(blockIdx.x) * kCarry;
  const int nchunk = (S + kChunk - 1) / kChunk;

  if (warp < 2) {                        // staging, kLag chunks ahead
    const int sid = threadIdx.x;
    for (int k = 0; k < nchunk; ++k) {
      const int b = k % kBufs;
      if (k >= kBufs) bar_sync(kEmpty + b);
      const int n = min(kChunk, S - k * kChunk);
      const int64_t row0 = slot0 + static_cast<int64_t>(k) * kChunk;
      for (int e = sid; e < n * kAp; e += kStagers) {
        const int t = e >> 5, c = e & 31;
        cp_async4(&st[b].xr[t][c], mr + (row0 + t) * kCh + c);
        cp_async4(&st[b].xi[t][c], mi + (row0 + t) * kCh + c);
      }
      for (int e = sid; e < n * kGroups; e += kStagers)
        cp_async4(&st[b].p[0][0] + e, p + row0 * kGroups + e);
      cp_async_commit();
      if (k >= kLag) {                   // chunk k - kLag has landed
        cp_async_wait<kLag>();
        __threadfence_block();
        bar_arrive(kFull + (k - kLag) % kBufs);
      }
    }
    for (int k = max(nchunk - kLag, 0); k < nchunk; ++k) {
      cp_async_wait<0>();
      __threadfence_block();
      bar_arrive(kFull + k % kBufs);
    }
    return;
  }

  if (warp < 4) {                        // warps 2-3: 16 channels a warp,
    const int ch = 16 * (warp - 2) + (lane >> 1);   // a lane pair a channel
    const bool im = lane & 1;
    const float sgn = im ? 1.0f : -1.0f;
    AllPass a;
    a.phr = coef[kPhiRe + ch];
    a.c2 = sgn * coef[kPhiIm + ch];
    a.dsf = coef[kDsf + ch];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      a.ser_r[m] = coef[kSerRe + 3 * ch + m];
      a.e2[m] = sgn * coef[kSerIm + 3 * ch + m];
      a.dser[m] = coef[kDser + m];
    }
    const int own2 = im ? kD2Im : kD2Re, oth2 = im ? kD2Re : kD2Im;
    a.d2a = cin[own2 + ch];
    a.d2b = cin[own2 + kAp + ch];
    a.d2ax = cin[oth2 + ch];
    a.d2bx = cin[oth2 + kAp + ch];
    const int o3 = im ? kR3Im : kR3Re, x3 = im ? kR3Re : kR3Im;
    const int o4 = im ? kR4Im : kR4Re, x4 = im ? kR4Re : kR4Im;
    const int o5 = im ? kR5Im : kR5Re, x5 = im ? kR5Re : kR5Im;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a.r3o[j] = cin[o3 + 3 * ch + j];
      a.r3x[j] = cin[x3 + 3 * ch + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a.r4o[j] = cin[o4 + 4 * ch + j];
      a.r4x[j] = cin[x4 + 4 * ch + j];
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      a.r5o[j] = cin[o5 + 5 * ch + j];
      a.r5x[j] = cin[x5 + 5 * ch + j];
    }
    for (int k = 0; k < nchunk; ++k) {
      const int b = k % kBufs;
      const int n = min(kChunk, S - k * kChunk);
      const int64_t o = (slot0 + static_cast<int64_t>(k) * kChunk) * kAp
                        + ch;
      float* d = (im ? d_im : d_re) + o;
      const float* xo = (im ? &st[b].xi[0][0] : &st[b].xr[0][0]) + ch;
      const float* xx = (im ? &st[b].xr[0][0] : &st[b].xi[0][0]) + ch;
      bar_sync(kFull + b);
      if (n == kChunk) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          a.step(xo[j * kAp], xx[j * kAp], d + j * kAp);
      } else {
#pragma unroll 1
        for (int j = 0; j < n; ++j)
          a.step(xo[j * kAp], xx[j * kAp], d + j * kAp);
      }
      if (k + kBufs < nchunk) bar_arrive(kEmpty + b);
    }
    cout[own2 + ch] = a.d2a;
    cout[own2 + kAp + ch] = a.d2b;
#pragma unroll
    for (int j = 0; j < 3; ++j) cout[o3 + 3 * ch + j] = a.r3o[j];
#pragma unroll
    for (int j = 0; j < 4; ++j) cout[o4 + 4 * ch + j] = a.r4o[j];
#pragma unroll
    for (int j = 0; j < 5; ++j) cout[o5 + 5 * ch + j] = a.r5o[j];
    return;
  }

  // warp 4: the 20 power chains, one a lane
  const bool live = lane < kGroups;
  const float pk = coef[kConst], ic = coef[kConst + 1], ti = coef[kConst + 2];
  float pd = 0.0f, ppd = 0.0f, pnrg = 0.0f;
  if (live) {
    pd = cin[kPow + lane];
    ppd = cin[kPow + kGroups + lane];
    pnrg = cin[kPow + 2 * kGroups + lane];
  }
  for (int k = 0; k < nchunk; ++k) {
    const int b = k % kBufs;
    const int n = min(kChunk, S - k * kChunk);
    const int64_t o = (slot0 + static_cast<int64_t>(k) * kChunk) * kGroups
                      + lane;
    bar_sync(kFull + b);
    if (live) {
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float pt = st[b].p[j][lane];
        pd = fmaxf(mul(pd, pk), pt);
        ppd = add(ppd, mul(ic, sub(sub(pd, pt), ppd)));
        pnrg = fmaxf(add(pnrg, mul(ic, sub(pt, pnrg))), 0.0f);
        ppd_out[o + j * kGroups] = ppd;
        nrg_out[o + j * kGroups] = mul(pnrg, ti);
      }
    }
    if (k + kBufs < nchunk) bar_arrive(kEmpty + b);
  }
  if (live) {
    cout[kPow + lane] = pd;
    cout[kPow + kGroups + lane] = ppd;
    cout[kPow + 2 * kGroups + lane] = pnrg;
  }
}

// 3. transient factor, long delays and mix, one thread per (slot,
// channel); blockIdx.x == 0 also writes the long rings' carry
__global__ void __launch_bounds__(kMapThreads)
ps_mix_out(const float* __restrict__ mr, const float* __restrict__ mi,
           const float* __restrict__ H, const float* __restrict__ carry_in,
           const float* __restrict__ coef, const int* __restrict__ imap,
           const float* __restrict__ ppd_in, const float* __restrict__ nrg_in,
           const float* __restrict__ d_re, const float* __restrict__ d_im,
           float* __restrict__ Lr, float* __restrict__ Li,
           float* __restrict__ Rr, float* __restrict__ Ri,
           float* __restrict__ carry_out, int S) {
  const int c = blockIdx.y;
  const int64_t slot0 = static_cast<int64_t>(c) * S;
  const float* cin = carry_in + static_cast<int64_t>(c) * kCarry;
  const int e = blockIdx.x * kMapThreads + threadIdx.x;
  if (e < S * kCh) {
    const int t = e / kCh, ch = e - t * kCh;
    const int64_t row = slot0 + t, o = row * kCh + ch;
    const float xr = mr[o], xi = mi[o];
    const int tg = __ldg(imap + kTgrp + ch), mg = __ldg(imap + kMgrp + ch);
    const float ppd = ppd_in[row * kGroups + tg];
    const float nrg = nrg_in[row * kGroups + tg];
    const float tc = ppd <= nrg ? 1.0f : __fdiv_rn(nrg, fmaxf(ppd, 1e-30f));
    float dr, di;
    if (ch < kAp) {
      dr = d_re[row * kAp + ch];
      di = d_im[row * kAp + ch];
    } else {
      const int l = ch - kAp, j = t + __ldg(imap + kLoff + l);
      if (j < kLng) {
        dr = cin[kLngRe + kLng * l + j];
        di = cin[kLngIm + kLng * l + j];
      } else {
        const int64_t src = o + static_cast<int64_t>(j - kLng - t) * kCh;
        dr = mr[src];
        di = mi[src];
      }
    }
    dr = mul(dr, tc);
    di = mul(di, tc);
    const float* h = H + row * (4 * kMix);
    const float h11 = h[mg], h12 = h[kMix + mg], h21 = h[2 * kMix + mg],
                h22 = h[3 * kMix + mg];
    const float mask = __ldg(coef + kMask + ch);
    Lr[o] = mul(add(mul(h11, xr), mul(h21, dr)), mask);
    Li[o] = mul(add(mul(h11, xi), mul(h21, di)), mask);
    Rr[o] = mul(add(mul(h12, xr), mul(h22, dr)), mask);
    Ri[o] = mul(add(mul(h12, xi), mul(h22, di)), mask);
  }
  if (blockIdx.x == 0) {                 // the long rings, oldest slot first
    float* cout = carry_out + static_cast<int64_t>(c) * kCarry;
    for (int k = threadIdx.x; k < kLong * kLng; k += kMapThreads) {
      const int l = k / kLng, s = S + (k - l * kLng);
      if (s < kLng) {
        cout[kLngRe + k] = cin[kLngRe + kLng * l + s];
        cout[kLngIm + k] = cin[kLngIm + kLng * l + s];
      } else {
        const int64_t src = (slot0 + s - kLng) * kCh + kAp + l;
        cout[kLngRe + k] = mr[src];
        cout[kLngIm + k] = mi[src];
      }
    }
  }
}

}  // namespace

// Scratch floats a slot of a stream that ohp_ps_mix takes.
extern "C" int ohp_ps_mix_scratch() { return kScratch; }

extern "C" int ohp_ps_mix(const float* mr, const float* mi, const float* H,
                          const float* carry_in, const float* coef,
                          const int* imap, float* scratch, float* Lr,
                          float* Li, float* Rr, float* Ri, float* carry_out,
                          int C, int S, cudaStream_t stream) {
  if (C > 0 && S > 0) {
    const int64_t n = static_cast<int64_t>(C) * S;
    float* p = scratch;
    float* ppd = p + n * kGroups;
    float* nrg = ppd + n * kGroups;
    float* d_re = nrg + n * kGroups;
    float* d_im = d_re + n * kAp;
    const dim3 grid_p((S * kGroups + kMapThreads - 1) / kMapThreads, C);
    ps_powers<<<grid_p, kMapThreads, 0, stream>>>(mr, mi, imap, p, S);
    ps_chains<<<C, kChainThreads, 0, stream>>>(mr, mi, carry_in, coef, p,
                                               ppd, nrg, d_re, d_im,
                                               carry_out, S);
    const dim3 grid_m((S * kCh + kMapThreads - 1) / kMapThreads, C);
    ps_mix_out<<<grid_m, kMapThreads, 0, stream>>>(
        mr, mi, H, carry_in, coef, imap, ppd, nrg, d_re, d_im, Lr, Li, Rr, Ri,
        carry_out, S);
  }
  return static_cast<int>(cudaGetLastError());
}
