// AAC TNS synthesis filtering for Hopper (sm_90a).
//
// Replaces `_tns_scan_device` of ohpipeline_tpu/codecs/aac/synthesis.py, the
// masked 1024-step lax.scan that `apply_tns_zz` runs twice (up, then down
// the flipped axis) over the pooled TNS rows of a serving group.  Per pooled
// row j the host's TnsPool gives a filter slot + 1 per bin (tfi, 0 = none),
// 24 slots of 12 direct-form coefficients (tco) and a direction per slot
// (tdir).  Pass d runs the bins upward (d = 0) or downward (d = 1); a bin is
// active when its slot runs in direction d; the 12-tap history resets where
// an active bin's slot differs from the previous bin's (-1 before the first
// bin), and y = x - dot(coefficients, history) on active bins.
//
// What bounds it: each row is a serial chain of up to 1024 dependent steps,
// and a group has only ~10^2-10^3 pooled rows, so the card is underused and
// the time is one row's chain latency.  The design keeps that chain short:
//   - one thread per pooled row; the history and the current slot's
//     coefficients live in registers, and the coefficients are read from
//     tco[j, slot] only where the slot changes (no per-bin coefficient
//     plane);
//   - the dot product sums the oldest taps first, so only the last fused
//     multiply-add waits for the previous bin's output: about two dependent
//     operations per bin, the other eleven overlap;
//   - bins move in chunks of 16 (four 16-byte loads of the row, one of its
//     slot bytes), and the next chunk is loaded while this one is filtered,
//     so memory latency is paid once per chunk and hidden behind the chain;
//   - an inactive bin neither loads nor stores: the reference shifts its
//     value into the history, but an active bin that follows an inactive one
//     always has another slot and resets the history, so that value is never
//     read.  Chunks with no active bin are not written back.
// Regions are contiguous and disjoint, so a row could later be split by
// filter slot (up to 24 ways) to put more threads on the card.
//
// Rows with trow outside [0, TB) are padding and skipped; a slot byte above
// 24 (which the host never writes) counts as inactive.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 1024;
constexpr int kSlots = 24;
constexpr int kOrder = 12;
constexpr int kChunk = 16;
constexpr int kThreads = 64;

struct Chunk {
  float v[kChunk];
  uint32_t f[kChunk / 4];  // slot bytes, little-endian in each word
};

__device__ __forceinline__ void load_chunk(Chunk& c, const float* x,
                                           const uint8_t* fi, int base) {
  const float4* src = reinterpret_cast<const float4*>(x + base);
#pragma unroll
  for (int q = 0; q < kChunk / 4; ++q) {
    const float4 t = src[q];
    c.v[4 * q] = t.x;
    c.v[4 * q + 1] = t.y;
    c.v[4 * q + 2] = t.z;
    c.v[4 * q + 3] = t.w;
  }
  const uint4 fw = *reinterpret_cast<const uint4*>(fi + base);
  c.f[0] = fw.x;
  c.f[1] = fw.y;
  c.f[2] = fw.z;
  c.f[3] = fw.w;
}

__device__ __forceinline__ void store_chunk(const Chunk& c, float* x,
                                            int base) {
  float4* dst = reinterpret_cast<float4*>(x + base);
#pragma unroll
  for (int q = 0; q < kChunk / 4; ++q)
    dst[q] = make_float4(c.v[4 * q], c.v[4 * q + 1], c.v[4 * q + 2],
                         c.v[4 * q + 3]);
}

template <int kDir>
__device__ __forceinline__ void tns_pass(float* x, const uint8_t* fi,
                                         const float* co,
                                         const uint8_t* dir) {
  float h[kOrder], c[kOrder];
#pragma unroll
  for (int t = 0; t < kOrder; ++t) h[t] = c[t] = 0.0f;
  int prev = -1;
  bool active = false;
  constexpr int kChunks = kBins / kChunk;
  auto chunk_base = [](int n) {
    return kDir == 0 ? n * kChunk : kBins - (n + 1) * kChunk;
  };
  Chunk cur, next;
  load_chunk(next, x, fi, chunk_base(0));
  for (int n = 0; n < kChunks; ++n) {
    cur = next;
    if (n + 1 < kChunks) load_chunk(next, x, fi, chunk_base(n + 1));
    bool touched = false;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const int k = kDir == 0 ? s : kChunk - 1 - s;
      const int f = (cur.f[k / 4] >> (8 * (k % 4))) & 0xff;
      if (f != prev) {
        prev = f;
        active = f > 0 && f <= kSlots && dir[f - 1] == kDir;
        if (active) {
          const float4* cs = reinterpret_cast<const float4*>(
              co + (f - 1) * kOrder);
#pragma unroll
          for (int q = 0; q < kOrder / 4; ++q) {
            const float4 t = cs[q];
            c[4 * q] = t.x;
            c[4 * q + 1] = t.y;
            c[4 * q + 2] = t.z;
            c[4 * q + 3] = t.w;
          }
#pragma unroll
          for (int t = 0; t < kOrder; ++t) h[t] = 0.0f;
        }
      }
      if (active) {
        float acc = 0.0f;
#pragma unroll
        for (int t = kOrder - 1; t >= 0; --t) acc = fmaf(c[t], h[t], acc);
        const float y = cur.v[k] - acc;
#pragma unroll
        for (int t = kOrder - 1; t > 0; --t) h[t] = h[t - 1];
        h[0] = y;
        cur.v[k] = y;
        touched = true;
      }
    }
    if (touched) store_chunk(cur, x, chunk_base(n));
  }
}

__global__ void __launch_bounds__(kThreads)
tns_rows(float* __restrict__ spec, int64_t TB,
         const uint8_t* __restrict__ tfi, const float* __restrict__ tco,
         const uint8_t* __restrict__ tdir, const int32_t* __restrict__ trow,
         int64_t P) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= P) return;
  const int64_t r = trow[j];
  if (r < 0 || r >= TB) return;
  float* x = spec + r * kBins;
  const uint8_t* fi = tfi + j * kBins;
  const float* co = tco + j * kSlots * kOrder;
  const uint8_t* dir = tdir + j * kSlots;
  tns_pass<0>(x, fi, co, dir);
  tns_pass<1>(x, fi, co, dir);
}

}  // namespace

extern "C" int ohp_tns_apply(float* spec, int64_t TB, const uint8_t* tfi,
                             const float* tco, const uint8_t* tdir,
                             const int32_t* trow, int64_t P,
                             cudaStream_t stream) {
  if (P > 0) {
    const int64_t blocks = (P + kThreads - 1) / kThreads;
    tns_rows<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        spec, TB, tfi, tco, tdir, trow, P);
  }
  return static_cast<int>(cudaGetLastError());
}
