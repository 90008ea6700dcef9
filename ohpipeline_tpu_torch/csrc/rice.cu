// FLAC rice-unit decode for Hopper (sm_90a).
//
// Replaces `_scan_units` of ohpipeline_tpu/codecs/flac/rice_jax.py:41-86,
// the 64-step lax.scan that decodes the rice wire on the TPU.  The host
// parser (native flac_parse_group_rice) cuts every partition into units of
// up to 64 residuals sharing one rice parameter, each with its own start bit
// cursor into a shared slab of the stream's bytes.  A unit decodes one
// residual per step: take the 32-bit big-endian window at the cursor, count
// the unary quotient (at most 15 on the wire, which the host guarantees by
// escaping longer codewords; 16 where the window's top 16 bits are zero),
// read k low bits, undo the zigzag, advance.  Verbatim units (mode 1) read k
// raw signed bits instead.  Lanes past `counts` neither advance nor write
// anything but zero.  Output is (U, 64) row-major int32, one row per unit.
//
// What bounds it: each unit's 64-step chain is short next to the card's
// parallelism (a main-path group has ~85,000 units, all resident at once),
// so what costs is memory transactions, and the bytes it must move are
// mostly its output (256 B a unit).  One thread per unit that reads two
// words a step and stores each residual into its own row makes every load
// and store of a warp touch 32 scattered sectors.  The design cuts both:
//   - each thread walks its unit through a 64-bit bit window held in
//     registers: the bits from the cursor on sit at the top, zeros below,
//     and before each residual the window is topped up to at least 32 valid
//     bits, one 32-bit word at a time; a unit at ~12 bits a residual reads
//     a word every ~3 residuals, not two every residual;
//   - the window's top 32 bits are the reference's `wnd` exactly: word j is
//     words[clip(j, 0, nw - 1)], the reference's clipping, so a walk past
//     the slab's end reads its last word again and a negative cursor its
//     first; `low` is cut from the 32-bit `wnd`, so a codeword longer than
//     32 bits reads zeros past the window, as the reference does;
//   - a warp's 32 units are consecutive, so their words mostly lie in one
//     span of the slab (~3 KB): the warp copies the span, from its lanes'
//     first word to kReach words past their last first word (as far as a
//     walk in the domain can read), into shared memory with cp.async, and
//     the top-ups read it there.  A warp whose span exceeds kStage words
//     (~2% on a main-path group: the overflow units at its tail) reads the
//     slab in global memory instead; the choice is warp-uniform;
//   - a warp's 32 units own 32 consecutive output rows, 8 KB in one piece:
//     the lanes write their residuals into a shared tile 16 steps at a time
//     (row stride 17 words: lane l's step i falls in bank (17 l + i) mod 32),
//     and after a __syncwarp the warp stores the tile's 2 KB with 16-byte
//     stores, so the stores leave while the next 16 steps decode;
//   - shared memory is addressed by 32-bit shared addresses taken once
//     (lds / sts), so no loop rebuilds a base.
// Shifts by 32 are undefined in C, so the reference's guards stay: k = 0
// reads no low bits and the raw shift is clipped to [0, 31].  Domain: rice k
// 0-30 and verbatim widths 0-32, for which a step consumes at most 47 bits,
// so two top-ups reach 32 valid bits from any state (out of the domain the
// staged reads are clamped to the warp's span, so they stay in bounds).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnit = 64;                   // residuals a unit
constexpr int kLanes = 32;
constexpr int kWarps = 4;                   // warps a block
constexpr int kThreads = kWarps * kLanes;
constexpr int kChunk = 16;                  // steps staged per tile store
constexpr int kStride = kChunk + 1;         // tile row stride in words
constexpr int kVec = kChunk / 4;            // 16-byte pieces of a row's chunk
constexpr int kCols = kVec < 8 ? kVec : 8;  // pieces of a row per store
constexpr int kRowsPer = kLanes / kCols;    // rows per store instruction
constexpr int kStage = 1536;                // slab words staged per warp
// words past its first that a unit's walk can read in the domain: 31 bits
// of phase and 64 x 47 bits of codewords, topped up to < 64 bits ahead
constexpr int kReach = 98;

__device__ __forceinline__ void sts(unsigned a, int32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t lds(unsigned a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// one 16-byte store of four registers (a vector store in PTX, so it stays
// one STG.128 whichever registers the values sit in)
__device__ __forceinline__ void stg4(int32_t* p, uint32_t x, uint32_t y,
                                     uint32_t z, uint32_t w) {
  asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(x), "r"(y), "r"(z), "r"(w)
               : "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Where a top-up finds word j: the warp's staged span in shared memory
// (words lo .. lo + kStage - 1 at `stage`), or the slab in global memory.
template <bool kStaged>
struct Words {
  const uint32_t* w;
  int last, lo;
  unsigned stage;
  __device__ __forceinline__ uint32_t operator()(int j) const {
    if constexpr (kStaged) {
      return lds(stage + 4u * min(j - lo, kStage - 1));
    } else {
      return __ldg(w + (j < 0 ? 0 : (j > last ? last : j)));
    }
  }
};

// The warp's 32 units: lane decodes its unit (cursor c, parameter k, mode
// raw, count cnt) 16 steps at a time into its row of the tile at `tile0`,
// and the warp stores each 16 steps of the first `rows` rows to dst.
template <bool kStaged>
__device__ __forceinline__ void walk(const Words<kStaged> word, int c, int k,
                                     bool raw, int cnt, int rows, int lane,
                                     unsigned tile0, int32_t* dst) {
  const int rsh = min(max(32 - k, 0), 31);  // verbatim sign extension
  // the window holds stream bits [cursor, cursor + nb) at its top; the next
  // word to load is nx
  uint64_t buf = 0;
  int nb = -(c & 31);
  int nx = c >> 5;
  const unsigned mine = tile0 + 4u * lane * kStride;
  for (int i0 = 0; i0 < kUnit; i0 += kChunk) {
    for (int i = 0; i < kChunk; ++i) {
      int32_t v = 0;
      if (i0 + i < cnt) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (nb < 32) {
            buf |= static_cast<uint64_t>(word(nx++)) << (32 - nb);
            nb += 32;
          }
        }
        const uint32_t wnd = static_cast<uint32_t>(buf >> 32);
        const int unary = min(__clz(wnd), 16);
        const uint32_t low = k > 0 ? (wnd << (unary + 1)) >> (32 - k) : 0u;
        const int32_t zz =
            static_cast<int32_t>((static_cast<uint32_t>(unary) << k) | low);
        const int32_t rice_v = (zz >> 1) ^ -(zz & 1);
        const int32_t raw_v = k > 0 ? static_cast<int32_t>(wnd) >> rsh : 0;
        v = raw ? raw_v : rice_v;
        const int adv = raw ? k : unary + 1 + k;
        buf <<= adv;
        nb -= adv;
      }
      sts(mine + 4u * i, v);
    }
    __syncwarp();
    // the chunk to global memory: lane takes 16-byte piece q of row r, so
    // one store instruction covers kRowsPer rows of kCols pieces each
    for (int it = 0; it < kVec; ++it) {
      const int r = (it / (kVec / kCols)) * kRowsPer + lane / kCols;
      const int q = (it % (kVec / kCols)) * kCols + lane % kCols;
      if (r < rows) {
        const unsigned a = tile0 + 4u * (r * kStride + 4 * q);
        stg4(dst + r * kUnit + i0 + 4 * q, lds(a), lds(a + 4), lds(a + 8),
             lds(a + 12));
      }
    }
    __syncwarp();
  }
}

// grid (ceil(U / kThreads)), block (kThreads): one thread per unit, warp w
// of a block owning units base .. base + 31.
__global__ void __launch_bounds__(kThreads)
rice_units(const uint32_t* __restrict__ words, int64_t nw,
           const int32_t* __restrict__ cur, const int32_t* __restrict__ kk,
           const int32_t* __restrict__ mode,
           const int32_t* __restrict__ counts, int32_t* __restrict__ out,
           int64_t U) {
  __shared__ __align__(16) int32_t tile[kWarps][kLanes * kStride];
  __shared__ __align__(16) uint32_t span[kWarps][kStage];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kLanes;
  if (base >= U) return;                    // warp-uniform
  const int rows = U - base < kLanes ? static_cast<int>(U - base) : kLanes;
  const int last = nw - 1 < INT_MAX ? static_cast<int>(nw - 1) : INT_MAX;
  int c = 0, k = 0, cnt = 0;
  bool raw = false;
  if (lane < rows) {
    c = cur[base + lane];
    k = kk[base + lane];
    raw = mode[base + lane] == 1;
    cnt = counts[base + lane];
  }
  // the span of the live lanes' first words, plus the reach of a walk
  const int lo = __reduce_min_sync(~0u, cnt > 0 ? c >> 5 : INT_MAX);
  const int hi = __reduce_max_sync(~0u, cnt > 0 ? c >> 5 : INT_MIN);
  const unsigned tile0 =
      static_cast<unsigned>(__cvta_generic_to_shared(&tile[warp][0]));
  const unsigned stage =
      static_cast<unsigned>(__cvta_generic_to_shared(&span[warp][0]));
  int32_t* const dst = out + base * kUnit;
  if (hi >= lo && hi - lo < kStage - kReach) {
    const int n = hi - lo + kReach;
    for (int s = lane; s < n; s += kLanes) {
      const int j = lo + s;
      cp_async4(stage + 4u * s, words + (j < 0 ? 0 : (j > last ? last : j)));
    }
    cp_async_wait_all();
    __syncwarp();
    walk(Words<true>{words, last, lo, stage}, c, k, raw, cnt, rows, lane,
         tile0, dst);
  } else {
    walk(Words<false>{words, last, lo, stage}, c, k, raw, cnt, rows, lane,
         tile0, dst);
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
