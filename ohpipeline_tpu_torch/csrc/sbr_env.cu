// SBR envelope smoothing, injection and tail carry for Hopper (sm_90a).
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
// The JAX program builds one-hot slot -> envelope matrices and multiplies
// them into the per-envelope planes; here env_id, prev_id and last_env are
// the small integer indices themselves.
//
// Every operation is per bin m, and within a frame the slots do not depend
// on each other: only the 6-slot tail and `filt` cross from one frame to
// the next.  So one thread runs one (channel, slot, bin) through the F
// frames: a block holds the 38 slots of one channel's bins (up to 26 bins,
// so at most 988 threads), neighbouring threads on neighbouring bins, so
// each load of the (C, F, 38, M) planes is coalesced.  The tail moves from
// the threads of slots 32-37 to those of slots 0-5 through shared memory,
// with two barriers a frame (everyone has read the old tail; the new one is
// written); each thread follows `filt` itself from last_env.  What bounds
// it: the F-step chain of barriers and the loads of each frame, ~6 float
// planes of (F, 38, M) per channel.  At the 16-stream serving group (C =
// 32, F = 48, M = 24) this is 29,184 threads and took 0.098 ms on an
// NVIDIA H100 80GB HBM3 (700 W), against 1.58 ms for one thread per
// (channel, bin) walking all 48 x 38 slots (768 threads: one warp on each
// of 24 SMs, which could not hide the latency of its loads).
// Regenerating the noise and sine planes here from the counter seeds,
// instead of reading them, is a later speed step.
//
// The arithmetic is written with explicit round-to-nearest float ops in
// the plain version's order (no fused multiply-add), so the kernel repeats
// `envelope_scan_torch` bit for bit on the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEnv = 8;                 // MAXE envelope rows per frame
constexpr int kSlots = 38;              // NSL buffered slots per frame
constexpr int kOut = 32;                // slots a frame outputs
constexpr int kTail = kSlots - kOut;    // slots carried to the next frame
constexpr int kTile = 26;               // bins per block: 26 x 38 <= 1024

__device__ __forceinline__ float mix(float r, float prev, float cur) {
  return __fadd_rn(__fmul_rn(r, prev), __fmul_rn(__fsub_rn(1.0f, r), cur));
}

// y = x * g + (re * n) * b + s * l, rounded step by step in that order
__device__ __forceinline__ float inject(float x, float g, float re, float n,
                                        float b, float s, float l) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, g), __fmul_rn(__fmul_rn(re, n), b)),
                   __fmul_rn(s, l));
}

// grid (bin tiles, C), block (tile, kSlots)
__global__ void sbr_env_scan(
    const float* __restrict__ gain, const float* __restrict__ noise,
    const float* __restrict__ sine, const float* __restrict__ sine_bins,
    const int8_t* __restrict__ env_id, const int8_t* __restrict__ prev_id,
    const int8_t* __restrict__ last_env, const float* __restrict__ r,
    const float* __restrict__ carry_mask, const float* __restrict__ nre,
    const float* __restrict__ nim, const float* __restrict__ sre,
    const float* __restrict__ sim, const float* __restrict__ er,
    const float* __restrict__ ei, const float* __restrict__ filt,
    const float* __restrict__ tail_r, const float* __restrict__ tail_i,
    float* __restrict__ out_r, float* __restrict__ out_i,
    float* __restrict__ filt_out, float* __restrict__ tail_r_out,
    float* __restrict__ tail_i_out, int F, int M) {
  __shared__ float held_r[kTail][kTile], held_i[kTail][kTile];
  const int tx = threadIdx.x;
  const int s = threadIdx.y;
  const int m = blockIdx.x * blockDim.x + tx;
  const int64_t c = blockIdx.y;
  const bool live = m < M;
  const int mm = live ? m : 0;          // dead lanes read bin 0, store nothing
  float fg = filt[(c * 2) * M + mm];
  float fn = filt[(c * 2 + 1) * M + mm];
  if (s < kTail) {
    held_r[s][tx] = tail_r[(c * kTail + s) * M + mm];
    held_i[s][tx] = tail_i[(c * kTail + s) * M + mm];
  }
  __syncthreads();
  for (int f = 0; f < F; ++f) {
    const int64_t cf = c * F + f;
    const int64_t cs = cf * kSlots + s;
    const int64_t q = cs * M + mm;                    // this slot's bin
    const float* G = gain + cf * kEnv * M + mm;       // envelope e at e * M
    const float* N = noise + cf * kEnv * M + mm;
    const int e = env_id[cs];
    const int p = prev_id[cs];
    const int ec = e < 0 ? 0 : e;                     // clamped, then selected
    const int pc = p < 0 || p >= kEnv ? 0 : p;
    float xr = er[q], xi = ei[q];
    if (carry_mask[cs] > 0.0f) {                      // the tail, then zeros
      const int k = s < kTail ? s : 0;
      xr = s < kTail ? held_r[k][tx] : 0.0f;
      xi = s < kTail ? held_i[k][tx] : 0.0f;
    }
    const float gp = p < 0 ? 0.0f : (p >= kEnv ? fg : G[pc * M]);
    const float np = p < 0 ? 0.0f : (p >= kEnv ? fn : N[pc * M]);
    const float g = mix(r[cs], gp, G[ec * M]);
    const float n = mix(r[cs], np, N[ec * M]);
    const float sl = sine[(cf * kEnv + ec) * M + mm];
    const float nb = __fsub_rn(1.0f, sine_bins[(cf * kEnv + ec) * M + mm]);
    const float yr = e >= 0 ? inject(xr, g, nre[q], n, nb, sre[q], sl) : xr;
    const float yi = e >= 0 ? inject(xi, g, nim[q], n, nb, sim[q], sl) : xi;
    __syncthreads();                                  // old tail read
    if (s < kOut) {
      if (live) {
        out_r[(cf * kOut + s) * M + m] = yr;
        out_i[(cf * kOut + s) * M + m] = yi;
      }
    } else {
      held_r[s - kOut][tx] = yr;
      held_i[s - kOut][tx] = yi;
    }
    __syncthreads();                                  // new tail written
    const int le = last_env[cf];
    if (le >= 0) {
      fg = G[le * M];
      fn = N[le * M];
    }
  }
  if (!live) return;
  if (s >= kOut) {
    tail_r_out[(c * kTail + s - kOut) * M + m] = held_r[s - kOut][tx];
    tail_i_out[(c * kTail + s - kOut) * M + m] = held_i[s - kOut][tx];
  } else if (s == 0) {
    filt_out[(c * 2) * M + m] = fg;
    filt_out[(c * 2 + 1) * M + m] = fn;
  }
}

}  // namespace

extern "C" int ohp_sbr_env_scan(
    const float* gain, const float* noise, const float* sine,
    const float* sine_bins, const int8_t* env_id, const int8_t* prev_id,
    const int8_t* last_env, const float* r, const float* carry_mask,
    const float* nre, const float* nim, const float* sre, const float* sim,
    const float* er, const float* ei, const float* filt,
    const float* tail_r, const float* tail_i, float* out_r, float* out_i,
    float* filt_out, float* tail_r_out, float* tail_i_out, int64_t C, int F,
    int M, cudaStream_t stream) {
  if (C > 0 && M > 0) {
    const int tile = M < kTile ? M : kTile;
    const dim3 block(tile, kSlots);
    const dim3 grid((M + tile - 1) / tile, static_cast<unsigned>(C));
    sbr_env_scan<<<grid, block, 0, stream>>>(
        gain, noise, sine, sine_bins, env_id, prev_id, last_env, r,
        carry_mask, nre, nim, sre, sim, er, ei, filt, tail_r, tail_i, out_r,
        out_i, filt_out, tail_r_out, tail_i_out, F, M);
  }
  return static_cast<int>(cudaGetLastError());
}
