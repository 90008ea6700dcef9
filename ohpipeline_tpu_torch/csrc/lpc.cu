// Batched, bit-exact FLAC LPC / fixed-predictor synthesis for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_lpc_kernel` of ohpipeline_tpu/ops/lpc.py
// (launched by `lpc_synthesize_pallas`).  Same contract:
//
//     s[n] = r[n]                                        for n < order
//     s[n] = r[n] + (sum_{i<32} c[i] * s[n-1-i] >> shift) otherwise
//
// with an int64 accumulator, an arithmetic (floor) shift and int32 wrap on
// the result.  History before n = 0 is zero, and all 32 coefficients take
// part (callers zero-pad past `order`), exactly as the TPU kernel does.  The
// TPU kept the dot product in three 12-bit limbs because it has no int64;
// the card does, so the limbs are gone.
//
// What bounds it: each sample costs 8 bytes of device traffic (residual in,
// sample out) against at most 32 multiply-adds, and each sample depends on
// the one before it, so the only parallelism is across rows.  A main-path
// group is about 1.1k rows of 4096 samples: one thread per row would fill
// only a few dozen warps on the card's 132 SMs, and each thread would walk a
// 32-entry history serially.
//
// Design: one warp per row.  Lane i holds coefficient c[i] and history entry
// s[n-1-i].  Each step multiplies lane-wise in int64, sums with a
// __shfl_xor_sync butterfly (every lane ends with the full sum), and shifts
// the history one lane up with __shfl_up_sync while lane 0 takes the new
// sample.  Residuals are read 32 at a time, one per lane (coalesced), and
// broadcast per step with __shfl_sync; the 32 outputs collect one per lane
// and are stored together.  The step's latency is the butterfly, so the
// kernel is latency-bound per row and relies on many rows per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lpc_warp_per_row(const int32_t* __restrict__ data,
                 const int32_t* __restrict__ coeffs,
                 const int32_t* __restrict__ shift,
                 const int32_t* __restrict__ order,
                 int32_t* __restrict__ out, int B, int N) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // uniform across the warp
  const int32_t* r = data + row * N;
  int32_t* s = out + row * N;
  const int64_t c = coeffs[row * kMaxOrder + lane];
  const int sh = shift[row];
  const int ord = order[row];
  int32_t h = 0;  // s[n-1-lane]
  for (int n0 = 0; n0 < N; n0 += 32) {
    const int m = min(32, N - n0);  // uniform across the warp
    const int32_t rv = lane < m ? r[n0 + lane] : 0;
    int32_t mine = 0;
    for (int j = 0; j < m; ++j) {
      int64_t acc = c * h;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
      const int32_t rn = __shfl_sync(kFull, rv, j);
      // int32 wrap of r + floor(acc / 2^shift), through unsigned adds
      const int32_t pred = static_cast<int32_t>(acc >> sh);
      const int32_t sn =
          (n0 + j < ord)
              ? rn
              : static_cast<int32_t>(static_cast<uint32_t>(rn) +
                                     static_cast<uint32_t>(pred));
      if (lane == j) mine = sn;
      const int32_t up = __shfl_up_sync(kFull, h, 1);
      h = lane == 0 ? sn : up;
    }
    if (lane < m) s[n0 + lane] = mine;
  }
}

}  // namespace

extern "C" int ohp_lpc_synthesize(const int32_t* data, const int32_t* coeffs,
                                  const int32_t* shift, const int32_t* order,
                                  int32_t* out, int B, int N,
                                  cudaStream_t stream) {
  if (B > 0 && N > 0) {
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    lpc_warp_per_row<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        data, coeffs, shift, order, out, B, N);
  }
  return static_cast<int>(cudaGetLastError());
}
