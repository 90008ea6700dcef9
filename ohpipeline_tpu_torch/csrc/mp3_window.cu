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
// slots after it, so the design keeps those re-reads on chip: one block per
// (granule, tile of kCT channels) copies the 18 + 15 rows its slots reach
// (rows 18 g .. 18 g + 32 of those channels, contiguous in vfull) into
// shared memory with 16-byte loads, then one thread per (slot, lane) sums
// its 16 products from shared memory (the 32 lanes of a warp read 32
// consecutive words: no bank conflict) and stores its sample (the block's
// 576 samples of a channel are contiguous in the output).  The window taps
// of a lane sit in registers.  The sum runs j = 0..15 in order with
// round-to-nearest multiplies and adds (no fused multiply-add), as the plain
// version's products and sum do, so the two agree to the rounding of the
// sum's order (<= 1 LSB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 18;              // polyphase slots per granule
constexpr int kHist = 15;               // V rows before a group's first slot
constexpr int kRows = kSlots + kHist;   // V rows a granule's slots read
constexpr int kV = 64;                  // V vector length
constexpr int kLanes = 32;
constexpr int kCT = 2;                  // channels a block computes

__global__ void __launch_bounds__(kSlots * kLanes)
mp3_window_granules(const float* __restrict__ vfull,
                    const float* __restrict__ wnd, int32_t* __restrict__ out,
                    int B, float scale, float lo, float hi) {
  __shared__ __align__(16) float sv[kRows][kCT][kV];
  const int g = blockIdx.x;
  const int b0 = blockIdx.y * kCT;
  const int nb = min(kCT, B - b0);
  const int lane = threadIdx.x;         // i
  const int slot = threadIdx.y;         // s: slot t = 18 g + s
  const int tid = slot * kLanes + lane;

  // rows 18 g .. 18 g + 32, channels b0 .. b0 + nb - 1: nb * 64 contiguous
  // floats a row, moved as float4
  const int per_row = nb * (kV / 4);
  for (int k = tid; k < kRows * per_row; k += kSlots * kLanes) {
    const int r = k / per_row, q = k - r * per_row;
    const int64_t src = ((static_cast<int64_t>(kSlots) * g + r) * B + b0)
                        * kV + 4 * q;
    *reinterpret_cast<float4*>(&sv[r][0][0] + 4 * q) =
        *reinterpret_cast<const float4*>(vfull + src);
  }
  float w[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = __ldg(wnd + j * kLanes + lane);
  __syncthreads();

  for (int c = 0; c < nb; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      acc = __fadd_rn(acc, __fmul_rn(w[2 * m], sv[kHist + slot - 2 * m][c][lane]));
      acc = __fadd_rn(acc, __fmul_rn(w[2 * m + 1],
                                     sv[kHist - 1 + slot - 2 * m][c][kLanes + lane]));
    }
    const float v = fminf(fmaxf(rintf(__fmul_rn(acc, scale)), lo), hi);
    out[(static_cast<int64_t>(g) * B + b0 + c) * (kSlots * kLanes)
        + slot * kLanes + lane] = static_cast<int32_t>(v);
  }
}

}  // namespace

extern "C" int ohp_mp3_window(const float* vfull, const float* wnd,
                              int32_t* out, int Tg, int B, int bit_depth,
                              cudaStream_t stream) {
  if (Tg > 0 && B > 0) {
    const float lim = static_cast<float>(1 << (bit_depth - 1));
    dim3 grid(static_cast<unsigned>(Tg),
              static_cast<unsigned>((B + kCT - 1) / kCT));
    mp3_window_granules<<<grid, dim3(kLanes, kSlots), 0, stream>>>(
        vfull, wnd, out, B, lim, -lim, lim - 1.0f);
  }
  return static_cast<int>(cudaGetLastError());
}
