// CELT pitch post-filter (feedback comb) over a group of frames, for Hopper
// (sm_90a).
//
// Replaces `_comb_device` of ohpipeline_tpu/codecs/opus/celt_jax.py:110-157
// (a `lax.scan` over 12-sample blocks, `:156`), which runs once per frame
// inside the frame scan of `device_decode_group` (`:201-204`).  Row r (stream
// r / CH) holds HLEN = 1026 carried samples, then the TDAC output of F frames
// of N = 960 samples.  Sample n of frame f is filtered in place:
//   y[t] += (1 - w) * taps(T0, g0) + w * taps(T1, g1),
//   taps(T, g) = g0 * y[t-T] + g1 * (y[t-T+1] + y[t-T-1])
//                + g2 * (y[t-T+2] + y[t-T-2]),
// with (T0, g0, T1, g1) = lags and tap gains 0 -> 1 for n < 120 and 1 -> 2
// after, and w = win2[n] (n < 120), win2[n - 120] (120 <= n < 240) or 1.
// Lags run from 15 to 1024; lags outside that range (only the zero padding of
// a partial group has them) are clamped to it, so every read stays in the
// row.
//
// The comb reads samples it has already filtered, so it is sequential at the
// scale of its lag: a run of samples whose reads all land before the run is
// independent, and with lag T a run may hold T - 2 samples.  What bounds it on
// this card is the chain of runs, not bytes (8.0 MB per 16-stream group is
// ~2.4 us at 3.35 TB/s): one block per row walks its frames in runs as long
// as the frame's lags allow, one thread per sample of a run, with a barrier
// between runs.  The first 120 samples of each segment read both tap sets,
// the rest of the second segment only the second (its weight 1 - w is 0); a
// tap set whose gains are all zero reads nothing and does not limit the run.
// The row sits in shared memory in windows of up to KF frames behind its
// 1026-sample history (35 KB a block), so any F fits.
//
// The arithmetic is written with explicit round-to-nearest float ops in the
// plain version's order (no fused multiply-add), so the kernel repeats
// `comb_torch` (ohpipeline_tpu_torch/codecs/opus/celt.py) bit for bit on the
// card, up to the sign of a zero.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 960;                 // samples per 20 ms frame
constexpr int kOv = 120;                // overlap: crossfade length
constexpr int kHlen = 1026;             // MAX_PERIOD + 2 carried samples
constexpr int kMinT = 15;               // COMBFILTER_MINPERIOD
constexpr int kMaxT = 1024;             // MAX_PERIOD
constexpr int kKF = 8;                  // frames per shared-memory window
constexpr int kThreads = 128;

__device__ __forceinline__ float taps(const float* x, const float* g) {
  return __fadd_rn(
      __fadd_rn(__fmul_rn(g[0], x[0]), __fmul_rn(g[1], __fadd_rn(x[1], x[-1]))),
      __fmul_rn(g[2], __fadd_rn(x[2], x[-2])));
}

// grid (R), block (kThreads)
__global__ void __launch_bounds__(kThreads)
celt_comb_rows(const float* __restrict__ y, const int32_t* __restrict__ Tv,
               const float* __restrict__ gt, const float* __restrict__ win2,
               float* __restrict__ out, float* __restrict__ hist, int CH,
               int F) {
  __shared__ float buf[kHlen + kKF * kN];
  __shared__ float w2[kOv];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int64_t s = row / CH;
  const float* yr = y + row * (kHlen + static_cast<int64_t>(F) * kN);
  float* outr = out + row * static_cast<int64_t>(F) * kN;
  for (int i = tid; i < kOv; i += kThreads) w2[i] = win2[i];
  for (int i = tid; i < kHlen; i += kThreads) buf[i] = yr[i];
  int kf = 0;
  for (int c0 = 0; c0 < F; c0 += kKF) {
    kf = F - c0 < kKF ? F - c0 : kKF;
    for (int i = tid; i < kf * kN; i += kThreads)
      buf[kHlen + i] = yr[kHlen + static_cast<int64_t>(c0) * kN + i];
    __syncthreads();
    for (int f = 0; f < kf; ++f) {
      const int64_t sf = s * F + c0 + f;
      int T[3];
      float g[3][3];
      bool on[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int t = Tv[sf * 3 + k];
        T[k] = t < kMinT ? kMinT : (t > kMaxT ? kMaxT : t);
        for (int j = 0; j < 3; ++j) g[k][j] = gt[(sf * 3 + k) * 3 + j];
        on[k] = g[k][0] != 0.0f || g[k][1] != 0.0f || g[k][2] != 0.0f;
      }
      float* x = buf + kHlen + f * kN;
      // pieces of the frame: [0, 120) sets 0 -> 1, [120, 240) sets 1 -> 2,
      // [240, 960) set 2 alone
#pragma unroll
      for (int piece = 0; piece < 3; ++piece) {
        const int lo = piece == 0 ? 0 : (piece == 1 ? kOv : 2 * kOv);
        const int hi = piece == 2 ? kN : lo + kOv;
        const int a = piece == 0 ? 0 : 1;
        const bool fade = piece < 2;
        const bool use0 = fade && on[a];
        const bool use1 = on[a + 1];
        int lag = hi - lo + 2;
        if (use0 && T[a] < lag) lag = T[a];
        if (use1 && T[a + 1] < lag) lag = T[a + 1];
        const int run = lag - 2;
        for (int r = lo; r < hi; r += run) {
          const int e = r + run < hi ? r + run : hi;
          for (int n = r + tid; n < e; n += kThreads) {
            const float w = fade ? w2[n - lo] : 1.0f;
            const float t0 = use0 ? taps(x + n - T[a], g[a]) : 0.0f;
            const float t1 = use1 ? taps(x + n - T[a + 1], g[a + 1]) : 0.0f;
            x[n] = __fadd_rn(__fadd_rn(x[n], __fmul_rn(__fsub_rn(1.0f, w), t0)),
                             __fmul_rn(w, t1));
          }
          __syncthreads();
        }
      }
    }
    for (int i = tid; i < kf * kN; i += kThreads)
      outr[static_cast<int64_t>(c0) * kN + i] = buf[kHlen + i];
    if (c0 + kKF < F) {                 // the window's last HLEN to its front
      for (int i = tid; i < kHlen; i += kThreads) buf[i] = buf[kKF * kN + i];
    }
    __syncthreads();
  }
  for (int i = tid; i < kHlen; i += kThreads)
    hist[row * kHlen + i] = buf[kf * kN + i];
}

}  // namespace

extern "C" int ohp_celt_comb(const float* y, const int32_t* Tv,
                             const float* gt, const float* win2, float* out,
                             float* hist, int64_t R, int CH, int F,
                             cudaStream_t stream) {
  if (R > 0) {
    celt_comb_rows<<<static_cast<unsigned>(R), kThreads, 0, stream>>>(
        y, Tv, gt, win2, out, hist, CH, F);
  }
  return static_cast<int>(cudaGetLastError());
}
