// FLAC rice-unit decode for Hopper (sm_90a).
//
// Replaces `_scan_units` of ohpipeline_tpu/codecs/flac/rice_jax.py, the
// 64-step lax.scan that decodes the rice wire on the TPU.  The host parser
// (native flac_parse_group_rice) cuts every partition into units of up to 64
// residuals sharing one rice parameter, each with its own start bit cursor
// into a shared slab of the stream's bytes.  A unit decodes one residual per
// step: take the 32-bit big-endian window at the cursor, count the unary
// quotient (at most 15, which the host guarantees by escaping longer
// codewords), read k low bits, undo the zigzag, advance.  Verbatim units
// (mode 1) read k raw signed bits instead.  Lanes past `counts` neither
// advance nor write anything but zero.
//
// What bounds it: two 4-byte word reads and about twenty integer operations
// per residual, with a dependency from one residual's length to the next
// cursor, so each unit is a serial chain and the parallelism is the number
// of units (tens of thousands per main-path group).  The word reads hit L2,
// since a unit's cursor walks forward through a few hundred bytes.
//
// Design: one thread per unit, a 64-step loop, `__clz` in place of the
// float-exponent trick the TPU used for the quotient.  Every guard of the
// reference is kept, since a shift by 32 is undefined in C: phase 0 takes
// the first word alone, k = 0 reads no low bits, the raw shift is clipped
// to [0, 31], and word indices are clipped to [0, nw - 1] so no read leaves
// the slab.  Output is (U, 64) row-major int32, one row per unit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnit = 64;
constexpr int kThreads = 128;

__device__ __forceinline__ int64_t clip_index(int64_t i, int64_t nw) {
  return i < 0 ? 0 : (i > nw - 1 ? nw - 1 : i);
}

__global__ void __launch_bounds__(kThreads)
rice_units(const uint32_t* __restrict__ words, int64_t nw,
           const int32_t* __restrict__ cur, const int32_t* __restrict__ kk,
           const int32_t* __restrict__ mode,
           const int32_t* __restrict__ counts, int32_t* __restrict__ out,
           int64_t U) {
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (u >= U) return;
  int32_t c = cur[u];
  const int k = kk[u];
  const bool raw = mode[u] == 1;
  const int cnt = counts[u];
  int32_t* o = out + u * kUnit;
  for (int i = 0; i < kUnit; ++i) {
    int32_t v = 0;
    if (i < cnt) {
      const int64_t wi = c >> 5;
      const uint32_t w0 = words[clip_index(wi, nw)];
      const uint32_t w1 = words[clip_index(wi + 1, nw)];
      const uint32_t phase = static_cast<uint32_t>(c) & 31u;
      const uint32_t wnd = phase ? (w0 << phase) | (w1 >> (32u - phase)) : w0;
      int adv;
      if (raw) {
        const int sh = min(max(32 - k, 0), 31);
        v = k > 0 ? (static_cast<int32_t>(wnd) >> sh) : 0;
        adv = k;
      } else {
        const uint32_t top16 = wnd >> 16;
        const int unary = top16 ? __clz(top16) - 16 : 16;
        const uint32_t low = k > 0 ? (wnd << (unary + 1)) >> (32 - k) : 0u;
        const int32_t zz =
            static_cast<int32_t>((static_cast<uint32_t>(unary) << k) | low);
        v = (zz >> 1) ^ -(zz & 1);
        adv = unary + 1 + k;
      }
      c += adv;
    }
    o[i] = v;
  }
}

}  // namespace

extern "C" int ohp_rice_decode_units(const uint32_t* words, int64_t nw,
                                     const int32_t* cur, const int32_t* kk,
                                     const int32_t* mode,
                                     const int32_t* counts, int32_t* out,
                                     int64_t U, cudaStream_t stream) {
  if (U > 0) {
    if (nw <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = (U + kThreads - 1) / kThreads;
    rice_units<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        words, nw, cur, kk, mode, counts, out, U);
  }
  return static_cast<int>(cudaGetLastError());
}
