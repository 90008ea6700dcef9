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
// ~2.4 us at 3.35 TB/s): real lags of 15-75 make ~15 runs a frame, most of
// them 65-73 samples, so the latency of one run is what the kernel takes.
// One warp walks one row, with nothing but a __syncwarp between runs, and
// the run's chain is kept short:
//   - a frame's pieces ([0, 120) sets 0 -> 1, [120, 240) sets 1 -> 2,
//     [240, 960) set 2 alone) each have one run length, so each picks once
//     how many consecutive samples a lane takes per run (K = 1 up to 32
//     samples, 3 up to 96) and loops over its runs with no other branch;
//   - a lane's K samples share their taps: it reads K + 4 samples of a tap
//     set rather than 5 K (10 shared-memory loads for 3 samples of the
//     frame's tail, not 18), and with K odd the lanes' reads fall in
//     distinct banks;
//   - a run's reads are all issued before its writes, lanes past the run's
//     end compute on samples they do not store (the row buffer is padded for
//     them), and a tap set is computed whether or not its gains are zero and
//     then selected, so nothing waits on a branch;
//   - runs longer than 96 samples (lags over 98, or pieces whose taps are
//     all off) take passes of 160 samples, 5 a lane;
//   - the run reads and writes shared memory through 32-bit shared
//     addresses taken once per piece (lds / sts): addressed through a
//     generic pointer, the compiler rebuilt the shared window's base
//     (S2UR SR_CgaCtaId) inside the run loop, on the chain of every run.
// The first 120 samples of each segment read both tap sets, the rest of the
// second segment only the second (its weight 1 - w is 0, and there
// (x + 0 * t0) + 1 * t1 is computed as x + t1, the same up to the sign of a
// zero); a tap set whose gains are all zero does not limit the run.  The row
// sits in shared memory in windows of up to KF frames behind its 1026-sample
// history (35 KB a row, one row a block, so the rows of a group spread over
// the SMs and any F fits), loaded by cp.async with the window's lags and
// gains beside it, so no global load waits at a frame's start.  The window
// is not double-buffered: with the next window's cp.async issued before
// this one's walk, the group took longer (the loads hit L2 and cost less
// than the second buffer's addressing cost the walk).
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
constexpr int kLanes = 32;
constexpr int kLong = 5;                // samples a lane takes in a long pass
constexpr int kPad = kLong * kLanes;    // read past a frame's end, unstored

// g0 * a[2] + g1 * (a[3] + a[1]) + g2 * (a[4] + a[0]): the taps around a[2]
__device__ __forceinline__ float taps(const float* a, const float* g) {
  return __fadd_rn(
      __fadd_rn(__fmul_rn(g[0], a[2]), __fmul_rn(g[1], __fadd_rn(a[3], a[1]))),
      __fmul_rn(g[2], __fadd_rn(a[4], a[0])));
}

// A piece of a frame: its first sample, and the tap sets it reads (lags T0,
// T1, gains g0, g1; set 0 only in the crossfade, set 1 always) with whether
// each has a nonzero gain.
struct Piece {
  int lo, T0, T1;
  bool use0, use1;
  float g0[3], g1[3];
};

// Shared-memory load and store at a 32-bit shared address.  The frame's
// samples are addressed this way, from a base taken once per piece, so that
// no run recomputes the shared window's base on its chain.
__device__ __forceinline__ float lds(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void sts(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

// K consecutive samples of a pass starting at b, lane l taking b + K l ..
// b + K l + K - 1, of a run ending at e; x and w2 are the shared addresses
// of the frame's sample 0 and of the crossfade window.  Neighbouring samples
// share their taps, so a lane reads K + 4 samples of a tap set rather than
// 5 K, and for odd K the lanes' reads fall in distinct banks.  Every read
// comes before every write; a sample at or past e is computed and not
// stored.
template <int K, bool FADE>
__device__ __forceinline__ void run_pass(unsigned x, unsigned w2,
                                         const Piece& p, int b, int e,
                                         int lane) {
  const int n0 = b + K * lane;
  float a1[K + 4], a0[K + 4], xs[K], v[K];
#pragma unroll
  for (int c = 0; c < K + 4; ++c) {
    a1[c] = lds(x + 4 * (n0 - p.T1 - 2 + c));
    if (FADE) a0[c] = lds(x + 4 * (n0 - p.T0 - 2 + c));
  }
#pragma unroll
  for (int c = 0; c < K; ++c) xs[c] = lds(x + 4 * (n0 + c));
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float t1r = taps(a1 + c, p.g1);
    const float t1 = p.use1 ? t1r : 0.0f;
    if (FADE) {
      const float w = lds(w2 + 4 * min(n0 + c - p.lo, kOv - 1));
      const float t0r = taps(a0 + c, p.g0);
      const float t0 = p.use0 ? t0r : 0.0f;
      v[c] = __fadd_rn(__fadd_rn(xs[c], __fmul_rn(__fsub_rn(1.0f, w), t0)),
                       __fmul_rn(w, t1));
    } else {                            // w = 1: (x + 0 * t0) + 1 * t1
      v[c] = __fadd_rn(xs[c], t1);
    }
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (n0 + c < e) sts(x + 4 * (n0 + c), v[c]);
  }
}

// The piece's samples [lo, hi) in runs of `run`, each one pass of K samples
// a lane, a __syncwarp after each run.
template <int K, bool FADE>
__device__ __forceinline__ void walk(unsigned x, unsigned w2,
                                     const Piece& p, int hi, int run,
                                     int lane) {
  for (int r = p.lo; r < hi; r += run) {
    run_pass<K, FADE>(x, w2, p, r, min(r + run, hi), lane);
    __syncwarp();
  }
}

// Runs longer than kPad samples: passes of kPad within each run.
template <bool FADE>
__device__ __forceinline__ void walk_long(unsigned x, unsigned w2,
                                          const Piece& p, int hi, int run,
                                          int lane) {
  for (int r = p.lo; r < hi; r += run) {
    const int e = min(r + run, hi);
    for (int b = r; b < e; b += kPad)
      run_pass<kLong, FADE>(x, w2, p, b, e, lane);
    __syncwarp();
  }
}

template <bool FADE>
__device__ __forceinline__ void walk_piece(unsigned x, unsigned w2,
                                           const Piece& p, int hi, int run,
                                           int lane) {
  const int len = min(run, hi - p.lo);
  if (len <= kLanes) {
    walk<1, FADE>(x, w2, p, hi, run, lane);
  } else if (len <= 3 * kLanes) {
    walk<3, FADE>(x, w2, p, hi, run, lane);
  } else {
    walk_long<FADE>(x, w2, p, hi, run, lane);
  }
}

// 8 bytes from global to shared memory, bypassing registers
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// grid (R), block (kLanes): one warp per row.  The wrapper checks that y is
// 8-byte aligned; every row and window then starts on an 8-byte boundary
// (1026 and 960 samples are even).
__global__ void __launch_bounds__(kLanes)
celt_comb_rows(const float* __restrict__ y, const int32_t* __restrict__ Tv,
               const float* __restrict__ gt, const float* __restrict__ win2,
               float* __restrict__ out, float* __restrict__ hist, int CH,
               int F) {
  __shared__ __align__(16) float buf[kHlen + kKF * kN + kPad];
  __shared__ float w2[kOv];
  __shared__ int32_t Tw[kKF * 3];       // the window's lags
  __shared__ float gw[kKF * 9];         // and tap gains
  const int lane = threadIdx.x;
  const unsigned w2s = static_cast<unsigned>(__cvta_generic_to_shared(w2));
  const int64_t row = blockIdx.x;
  const int64_t s = row / CH;
  const float* yr = y + row * (kHlen + static_cast<int64_t>(F) * kN);
  float* outr = out + row * static_cast<int64_t>(F) * kN;
  for (int i = lane; i < kOv; i += kLanes) cp_async4(w2 + i, win2 + i);
  for (int i = 2 * lane; i < kHlen; i += 2 * kLanes)
    cp_async8(buf + i, yr + i);
  for (int i = lane; i < kPad; i += kLanes)   // read, never stored or output
    buf[kHlen + kKF * kN + i] = 0.0f;
  int kf = 0;
  for (int c0 = 0; c0 < F; c0 += kKF) {
    kf = F - c0 < kKF ? F - c0 : kKF;
    const float* src = yr + kHlen + static_cast<int64_t>(c0) * kN;
    for (int i = 2 * lane; i < kf * kN; i += 2 * kLanes)
      cp_async8(buf + kHlen + i, src + i);
    for (int i = lane; i < kf * 3; i += kLanes)
      cp_async4(Tw + i, Tv + (s * F + c0) * 3 + i);
    for (int i = lane; i < kf * 9; i += kLanes)
      cp_async4(gw + i, gt + (s * F + c0) * 9 + i);
    cp_async_wait_all();
    __syncwarp();
    for (int f = 0; f < kf; ++f) {
      int T[3];
      float g[3][3];
      bool on[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int t = Tw[f * 3 + k];
        T[k] = t < kMinT ? kMinT : (t > kMaxT ? kMaxT : t);
#pragma unroll
        for (int j = 0; j < 3; ++j) g[k][j] = gw[(f * 3 + k) * 3 + j];
        on[k] = g[k][0] != 0.0f || g[k][1] != 0.0f || g[k][2] != 0.0f;
      }
      const unsigned x =
          static_cast<unsigned>(__cvta_generic_to_shared(buf + kHlen + f * kN));
#pragma unroll 1
      for (int piece = 0; piece < 3; ++piece) {
        const bool first = piece == 0;
        const bool fade = piece < 2;
        Piece p;
        p.lo = first ? 0 : (fade ? kOv : 2 * kOv);
        p.T0 = first ? T[0] : T[1];
        p.T1 = first ? T[1] : T[2];
        p.use0 = fade && (first ? on[0] : on[1]);
        p.use1 = first ? on[1] : on[2];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          p.g0[j] = first ? g[0][j] : g[1][j];
          p.g1[j] = first ? g[1][j] : g[2][j];
        }
        const int hi = fade ? p.lo + kOv : kN;
        int lag = hi - p.lo + 2;
        if (p.use0 && p.T0 < lag) lag = p.T0;
        if (p.use1 && p.T1 < lag) lag = p.T1;
        if (fade) {
          walk_piece<true>(x, w2s, p, hi, lag - 2, lane);
        } else {
          walk_piece<false>(x, w2s, p, hi, lag - 2, lane);
        }
      }
    }
    float* dst = outr + static_cast<int64_t>(c0) * kN;
    for (int i = 2 * lane; i < kf * kN; i += 2 * kLanes)
      *reinterpret_cast<float2*>(dst + i) =
          *reinterpret_cast<const float2*>(buf + kHlen + i);
    if (c0 + kKF < F) {                 // the window's last HLEN to its front
      __syncwarp();
      for (int i = lane; i < kHlen; i += kLanes) buf[i] = buf[kKF * kN + i];
      __syncwarp();
    }
  }
  cp_async_wait_all();                  // F = 0: the history alone
  __syncwarp();
  float* hr = hist + row * kHlen;
  for (int i = 2 * lane; i < kHlen; i += 2 * kLanes)
    *reinterpret_cast<float2*>(hr + i) =
        *reinterpret_cast<const float2*>(buf + kf * kN + i);
}

}  // namespace

extern "C" int ohp_celt_comb(const float* y, const int32_t* Tv,
                             const float* gt, const float* win2, float* out,
                             float* hist, int64_t R, int CH, int F,
                             cudaStream_t stream) {
  if (R > 0) {
    celt_comb_rows<<<static_cast<unsigned>(R), kLanes, 0, stream>>>(
        y, Tv, gt, win2, out, hist, CH, F);
  }
  return static_cast<int>(cudaGetLastError());
}
