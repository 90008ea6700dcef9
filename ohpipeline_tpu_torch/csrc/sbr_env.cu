// SBR envelope smoothing, noise and sine injection and tail carry for Hopper
// (sm_90a), as a map over (channel, frame, slot, bin).
//
// Replaces the frame scan of `device_decode_group` in
// ohpipeline_tpu/codecs/aac/sbr_jax.py:489-559 (`frame_step` under
// `lax.scan`).  For each channel c and frame f, over the 38 buffered QMF
// slots s of the frame and every SBR bin m:
//   - a slot with carry_mask set takes the previous frame's adjusted slot
//     32 + s (zero past the 6 carried slots) in place of the patched one;
//   - an active slot (env_id e >= 0) gets the smoothed gain and noise level
//     r * prev + (1 - r) * cur, where cur is envelope e's and prev is
//     envelope prev_id's of this frame, or the carried `filt` when prev_id
//     is MAXE; then y = x * gain + noise * level * (1 - sine bin) + sine *
//     sine level; an inactive slot passes x through;
//   - slots 0-31 are the frame's output, slots 32-37 the next frame's tail;
//   - a frame with a last envelope leaves that envelope's gain and noise
//     level in `filt`.
// The noise value of an active slot is entry (noise_idx0 + k * M + 1 + m)
// mod 512 of the noise tables, times 1 - no_noise of its envelope, and its
// sine value is +-inject_cal on the axis of phase (sine_ph0 + k) mod 4 where
// its envelope has a sine in bin m (the imaginary one signed by the bin's
// parity), k being the number of active slots before it in the group
// (k_ord): the host advances its counters by M and by 1 per active slot.
//
// The scan carries only two things from frame to frame, and neither needs
// the previous frame's carry:
//   - the tail: frame f's carried slot s < 6 is frame f - 1's output slot
//     32 + s, whose own carried value, if it has one, is the zero pad (a
//     carried slot >= 6 reads zeros);
//   - `filt`: the gain and noise of the last envelope of the latest earlier
//     frame that has one, or the carried input: a selection, not a sum.
// So nothing is sequential: one thread computes one (channel, frame, slot,
// bin) of the (C, F, 38, M) planes, recomputing frame f - 1's slot 32 + s
// where it is carried and walking back over the channel's last_env bytes
// (L1-resident) where it smooths against `filt`.  At the 16-stream serving
// group (C = 32, F = 48, M = 24) that is 1.4 million threads over every SM,
// neighbouring threads on neighbouring bins, so the plane loads and the
// stores coalesce.  What bounds it is bytes: the envelope planes, the
// patched slots er / ei and the output planes (~26 MB at that shape); the
// noise and sine values are made here from the counters and tables rather
// than read as four more slot planes.
//
// The arithmetic is written with explicit round-to-nearest float ops in
// the plain version's order (no fused multiply-add), so the kernel repeats
// `noise_sine_planes` followed by `envelope_scan_torch` bit for bit on the
// card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEnv = 8;                 // MAXE envelope rows per frame
constexpr int kSlots = 38;              // NSL buffered slots per frame
constexpr int kOut = 32;                // slots a frame outputs
constexpr int kTail = kSlots - kOut;    // slots carried to the next frame
constexpr int kThreads = 256;

struct Args {
  const float *gain, *noise, *sine, *sine_bins;      // (C, F, 8, M)
  const int8_t *env_id, *prev_id;                    // (C, F, 38)
  const int8_t* last_env;                            // (C, F)
  const float *r, *carry_mask;                       // (C, F, 38)
  const int32_t* k_ord;                              // (C, F, 38)
  const int32_t *noise_idx0, *sine_ph0;              // (C,)
  const float* no_noise;                             // (C, F, 8)
  const float *noise_re, *noise_im;                  // (512,)
  const float* parity;                               // (M,)
  float cal;
  const float *er, *ei;                              // (C, F, 38, M)
  const float* filt;                                 // (C, 2, M)
  const float *tail_r, *tail_i;                      // (C, 6, M)
  float *out_r, *out_i;                              // (C, F, 32, M)
  float* filt_out;                                   // (C, 2, M)
  float *tail_r_out, *tail_i_out;                    // (C, 6, M)
  int F, M;
};

__device__ __forceinline__ float mix(float r, float prev, float cur) {
  return __fadd_rn(__fmul_rn(r, prev), __fmul_rn(__fsub_rn(1.0f, r), cur));
}

// y = x * g + (re * n) * b + s * l, rounded step by step in that order
__device__ __forceinline__ float inject(float x, float g, float re, float n,
                                        float b, float s, float l) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, g), __fmul_rn(__fmul_rn(re, n), b)),
                   __fmul_rn(s, l));
}

// The carried gain and noise level of bin m at the start of frame f: those
// of the last envelope of the latest frame before f that has one, else the
// input filt.
__device__ __forceinline__ void filt_at(const Args& a, int c, int f, int m,
                                        float* fg, float* fn) {
  const int8_t* le = a.last_env + c * a.F;
  for (int k = f - 1; k >= 0; --k) {
    const int e = le[k];
    if (e >= 0) {
      const int q = ((c * a.F + k) * kEnv + e) * a.M + m;
      *fg = a.gain[q];
      *fn = a.noise[q];
      return;
    }
  }
  *fg = a.filt[(c * 2) * a.M + m];
  *fn = a.filt[(c * 2 + 1) * a.M + m];
}

// Slot s of frame f, bin m, adjusted from its input (xr, xi).
__device__ __forceinline__ void adjust(const Args& a, int c, int f, int s,
                                       int m, float xr, float xi, float* yr,
                                       float* yi) {
  const int cf = c * a.F + f;
  const int cs = cf * kSlots + s;
  const int e = a.env_id[cs];
  if (e < 0) {
    *yr = xr;
    *yi = xi;
    return;
  }
  const int p = a.prev_id[cs];
  const float* G = a.gain + cf * kEnv * a.M + m;     // envelope j at j * M
  const float* N = a.noise + cf * kEnv * a.M + m;
  float gp = 0.0f, np = 0.0f;
  if (p >= kEnv) {
    filt_at(a, c, f, m, &gp, &np);
  } else if (p >= 0) {
    gp = G[p * a.M];
    np = N[p * a.M];
  }
  const float rr = a.r[cs];
  const float g = mix(rr, gp, G[e * a.M]);
  const float n = mix(rr, np, N[e * a.M]);
  const int qe = (cf * kEnv + e) * a.M + m;
  const float sl = a.sine[qe];
  const float sb = a.sine_bins[qe];
  const float nb = __fsub_rn(1.0f, sb);
  const int k = a.k_ord[cs];
  const int ni = ((a.noise_idx0[c] & 511) + k * a.M + 1 + m) & 511;
  const float nm = __fsub_rn(1.0f, a.no_noise[cf * kEnv + e]);
  const float nre = __fmul_rn(a.noise_re[ni], nm);
  const float nim = __fmul_rn(a.noise_im[ni], nm);
  const int ph = (a.sine_ph0[c] + k) & 3;
  const float ph_re = ph == 0 ? 1.0f : (ph == 2 ? -1.0f : 0.0f);
  const float ph_im = ph == 1 ? 1.0f : (ph == 3 ? -1.0f : 0.0f);
  const float sre = __fmul_rn(__fmul_rn(ph_re, sb), a.cal);
  const float sim =
      __fmul_rn(__fmul_rn(__fmul_rn(ph_im, a.parity[m]), sb), a.cal);
  *yr = inject(xr, g, nre, n, nb, sre, sl);
  *yi = inject(xi, g, nim, n, nb, sim, sl);
}

// grid (ceil(C * F * 38 * M / kThreads)), block (kThreads): thread t is bin
// m = t mod M of slot s of frame f of channel c, t = ((c F + f) 38 + s) M + m
__global__ void __launch_bounds__(kThreads)
sbr_env_map(const Args a, int total) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int m = t % a.M;
  const int cs = t / a.M;
  const int s = cs % kSlots;
  const int cf = cs / kSlots;
  const int f = cf % a.F;
  const int c = cf / a.F;
  if (s >= kOut && f < a.F - 1) return;   // read by frame f + 1 as its tail
  float xr, xi;
  if (a.carry_mask[cs] > 0.0f) {          // the tail, then zeros
    if (s >= kTail) {
      xr = xi = 0.0f;
    } else if (f == 0) {
      xr = a.tail_r[(c * kTail + s) * a.M + m];
      xi = a.tail_i[(c * kTail + s) * a.M + m];
    } else {                              // frame f - 1's slot 32 + s
      const int ps = cs - kSlots + kOut;
      float pr = 0.0f, pi = 0.0f;
      if (!(a.carry_mask[ps] > 0.0f)) {
        pr = a.er[ps * a.M + m];
        pi = a.ei[ps * a.M + m];
      }
      adjust(a, c, f - 1, kOut + s, m, pr, pi, &xr, &xi);
    }
  } else {
    xr = a.er[t];
    xi = a.ei[t];
  }
  float yr, yi;
  adjust(a, c, f, s, m, xr, xi, &yr, &yi);
  if (s < kOut) {
    a.out_r[(cf * kOut + s) * a.M + m] = yr;
    a.out_i[(cf * kOut + s) * a.M + m] = yi;
    if (s == 0 && f == a.F - 1) {
      float fg, fn;
      filt_at(a, c, a.F, m, &fg, &fn);
      a.filt_out[(c * 2) * a.M + m] = fg;
      a.filt_out[(c * 2 + 1) * a.M + m] = fn;
    }
  } else {
    a.tail_r_out[(c * kTail + s - kOut) * a.M + m] = yr;
    a.tail_i_out[(c * kTail + s - kOut) * a.M + m] = yi;
  }
}

}  // namespace

extern "C" int ohp_sbr_env_map(
    const float* gain, const float* noise, const float* sine,
    const float* sine_bins, const int8_t* env_id, const int8_t* prev_id,
    const int8_t* last_env, const float* r, const float* carry_mask,
    const int32_t* k_ord, const int32_t* noise_idx0, const int32_t* sine_ph0,
    const float* no_noise, const float* noise_re, const float* noise_im,
    const float* parity, float cal, const float* er, const float* ei,
    const float* filt, const float* tail_r, const float* tail_i, float* out_r,
    float* out_i, float* filt_out, float* tail_r_out, float* tail_i_out,
    int64_t C, int F, int M, cudaStream_t stream) {
  const int64_t total = C * F * kSlots * M;
  if (total > 0 && total < (int64_t{1} << 31)) {
    const Args a{gain,     noise,      sine,       sine_bins, env_id,
                 prev_id,  last_env,   r,          carry_mask, k_ord,
                 noise_idx0, sine_ph0, no_noise,   noise_re,  noise_im,
                 parity,   cal,        er,         ei,        filt,
                 tail_r,   tail_i,     out_r,      out_i,     filt_out,
                 tail_r_out, tail_i_out, F,        M};
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    sbr_env_map<<<blocks, kThreads, 0, stream>>>(a, static_cast<int>(total));
  }
  return static_cast<int>(cudaGetLastError());
}
