// MP3 polyphase window pass (the 512-tap synthesis FIR over the V-FIFO),
// straight into int PCM, for Hopper (sm_90a).
//
// Replaces the polyphase scan of `hybrid_synthesis` in
// ohpipeline_tpu/codecs/mp3/synthesis.py:346-355 (a `lax.scan` over the 18
// polyphase steps of a granule, carrying the 16 x 64 V-FIFO), in the
// scan-free form the serving path runs (`hybrid_synthesis_parallel`,
// `:399-422`: 16 shifted slices of the V history stacked into a (T, B, 16,
// 32) U, times the window, summed, rounded, clipped and transposed).
// Inputs: vfull (15 + T, B, 64) float32, the 15 newest carried V vectors
// oldest first and then the group's T = 18 Tg slots; wnd (16, 32).  For slot
// t, channel b and lane i:
//   pcm = clip(rint(2^(bd-1) * sum_j wnd[j][i] * U_j)),
//   U_2m = vfull[15 + t - 2m][b][i], U_2m+1 = vfull[14 + t - 2m][b][32 + i],
// written as int32 at out[t / 18][b][(t % 18) * 32 + i], so no transpose
// follows.
//
// What bounds it on this card is bytes: it reads each V vector once from
// device memory and writes each sample once (at the serving width, Tg 64 and
// B 32, 9.56 MB in and 4.72 MB out, ~4.3 us at 3.35 TB/s), while its 32
// float operations a sample take ~0.56 us.  Each V row is read by the 16
// slots after it, so the design keeps those re-reads on chip, and reads each
// row from device memory about once: one block per (run of kRun granules,
// channel) walks its run in order through a ring of kRing V rows in shared
// memory (addressed by row number modulo kRing).  It requests the run's 15
// history rows and each granule's 18 new rows once, all at the start, with
// 16-byte cp.async copies, one group a granule, and sums each granule as
// soon as its group has landed, so later granules' rows arrive while the
// first is summed; the 15 newest rows stay in the ring for the next
// granule.  Rows are read (18 kRun + 15) / (18 kRun) times: 1.21 at
// kRun 4, against 1.83 with one block per granule.  At the serving shape
// the grid is 16 runs x 32 channels = 512 blocks of 144 threads (one block
// a channel rather than a pair: an odd channel count leaves no half-empty
// blocks, and the blocks spread evenly over the 132 SMs).  One thread per
// (slot, 4 lanes) sums its lanes' 16 products from shared memory with
// 16-byte loads (8 threads of a slot read 128 consecutive bytes: no bank
// conflict), four independent sums side by side, and stores its 4 samples
// with one 16-byte store (a granule's 576 samples of a channel are
// contiguous in the output).  The window taps of its lanes sit in
// registers.  Each sum runs j = 0..15 in order with round-to-nearest
// multiplies and adds (no fused multiply-add), as the plain version's
// products and sum do, so the two agree to the rounding of the sum's order
// (<= 1 LSB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 18;              // polyphase slots per granule
constexpr int kHist = 15;               // V rows before a group's first slot
constexpr int kV = 64;                  // V vector length
constexpr int kLanes = 32;
constexpr int kRun = 4;                 // granules a block walks
constexpr int kRing = 128;              // V rows held, a power of two
constexpr int kQuads = kLanes / 4;      // threads of a slot's 32 lanes
constexpr int kThreads = kSlots * kQuads;
static_assert(kHist + kSlots * kRun <= kRing, "the ring holds a run");
static_assert(kRun <= 4, "wait_pending counts up to 3 groups in flight");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

// copy V rows [r_lo, r_hi) of channel b into the ring, as one cp.async
// group (an empty group when r_lo == r_hi)
__device__ __forceinline__ void load_rows(float* ring,
                                          const float* __restrict__ vfull,
                                          int r_lo, int r_hi, int B, int b,
                                          int tid) {
  for (int k = tid; k < (r_hi - r_lo) * (kV / 4); k += kThreads) {
    const int r = r_lo + k / (kV / 4), q = k % (kV / 4);
    cp_async16(ring + (r & (kRing - 1)) * kV + 4 * q,
               vfull + (static_cast<int64_t>(r) * B + b) * kV + 4 * q);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (0-3) of this thread's cp.async groups are
// in flight
__device__ __forceinline__ void wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  }
}

__device__ __forceinline__ void madd4(float4& acc, const float4& w,
                                      const float* v) {
  const float4 x = *reinterpret_cast<const float4*>(v);
  acc.x = __fadd_rn(acc.x, __fmul_rn(w.x, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w.y, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w.z, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w.w, x.w));
}

__device__ __forceinline__ int pcm(float a, float scale, float lo,
                                   float hi) {
  return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(a, scale)), lo), hi));
}

__global__ void __launch_bounds__(kThreads)
mp3_window_runs(const float* __restrict__ vfull,
                const float* __restrict__ wnd, int32_t* __restrict__ out,
                int Tg, int B, float scale, float lo, float hi) {
  __shared__ __align__(16) float ring[kRing * kV];
  const int g0 = blockIdx.x * kRun;
  const int n = min(kRun, Tg - g0);
  const int b = blockIdx.y;
  const int quad = threadIdx.x;         // lanes 4 quad .. 4 quad + 3
  const int slot = threadIdx.y;         // s: slot t = 18 g + s
  const int tid = slot * kQuads + quad;

  // the run's history with its first granule, then one group a granule
  // (empty past the run's end)
  load_rows(ring, vfull, kSlots * g0, kSlots * g0 + kHist + kSlots, B, b,
            tid);
#pragma unroll
  for (int i = 1; i < kRun; ++i) {
    const int r = kSlots * (g0 + i) + kHist;
    load_rows(ring, vfull, r, i < n ? r + kSlots : r, B, b, tid);
  }
  float4 w[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float* p = wnd + j * kLanes + 4 * quad;
    w[j] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }

  for (int i = 0; i < n; ++i) {
    const int g = g0 + i;
    wait_pending(kRun - 1 - i);         // granule g's rows have landed
    __syncthreads();
    const int r0 = kSlots * g + kHist + slot;   // U_0's row
    const float* q = ring + 4 * quad;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      madd4(acc, w[2 * m], q + ((r0 - 2 * m) & (kRing - 1)) * kV);
      madd4(acc, w[2 * m + 1],
            q + ((r0 - 1 - 2 * m) & (kRing - 1)) * kV + kLanes);
    }
    *reinterpret_cast<int4*>(
        out + (static_cast<int64_t>(g) * B + b) * (kSlots * kLanes)
        + slot * kLanes + 4 * quad) =
        make_int4(pcm(acc.x, scale, lo, hi), pcm(acc.y, scale, lo, hi),
                  pcm(acc.z, scale, lo, hi), pcm(acc.w, scale, lo, hi));
  }
}

}  // namespace

extern "C" int ohp_mp3_window(const float* vfull, const float* wnd,
                              int32_t* out, int Tg, int B, int bit_depth,
                              cudaStream_t stream) {
  if (Tg > 0 && B > 0) {
    const float lim = static_cast<float>(1 << (bit_depth - 1));
    dim3 grid(static_cast<unsigned>((Tg + kRun - 1) / kRun),
              static_cast<unsigned>(B));
    mp3_window_runs<<<grid, dim3(kQuads, kSlots), 0, stream>>>(
        vfull, wnd, out, Tg, B, lim, -lim, lim - 1.0f);
  }
  return static_cast<int>(cudaGetLastError());
}
