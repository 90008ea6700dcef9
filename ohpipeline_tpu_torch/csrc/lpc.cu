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
// What bounds it on this card: not bytes (8 a sample) but the chain.  Each
// sample waits for the one before it, and a serving group is ~1.1k rows of
// 4096 samples, so the kernel takes N times the latency of one step of the
// chain.  The first design (one warp per row, a 5-level int64 shuffle
// butterfly per sample plus a blocking residual load every 32 samples) took
// 0.516 ms on a 1152 x 4096 group, ~225 cycles a sample, against 11.3 us to
// move the bytes (H100 80GB HBM3, 700 W).
//
// Design: the sum is split so that only the newest term waits.  A row's G
// lanes own G consecutive outputs (a block); lane k owns output n0 + k.
// Lane k keeps one int64 accumulator and coefficient w[j] = c[(k-1-j) mod G]
// in a register for each step j.  Step j of a block: lane j finishes its
// output (add r, shift, wrap, or the residual itself in the warm-up),
// broadcasts it with one 32-bit __shfl_sync and restarts its accumulator;
// every lane then adds w[j] * s_j with one IMAD.  For lanes k > j that is
// term k-1-j of this block's output; for lanes k <= j it is term G+k-1-j of
// the next block's output, so each sum is complete by the time its owner
// finishes it and nothing is ever recomputed or reduced.  The sum's terms
// are added in another order than the plain version's, which integer
// addition (mod 2^64) does not see, so the result is bit-exact by
// construction.  The chain per sample is the shuffle, the wide multiply and
// its 64-bit add (IMAD.WIDE, IADD3, IMAD.X), a funnel shift and an add.
//   - Order-aware: a term reaching back k samples needs G >= k.  A block of
//     4 rows whose coefficients past c[7] are all zero (a real group is
//     almost all order 8) runs on warp 0 alone, 8 lanes a row and one
//     shuffle serving all four rows; any wider row sends each row to its
//     own warp with G = 32.  One block-uniform branch.
//   - Residuals reach shared memory by cp.async, 128 samples of a row at a
//     time, one piece ahead of the chain (16-byte copies when N % 4 == 0 and
//     the rows are 16-byte aligned, else 4-byte ones), so no global load
//     waits in the chain; outputs collect in shared memory and leave as
//     16-byte coalesced stores.
//   - No tensor cores: the products reach ~2^40 and need an int64
//     accumulator; Hopper's integer tensor cores take int8 operands and
//     accumulate in int32.
// Measured (H100 80GB HBM3, 700 W; tools/kernel_ab.py, PERF.md): 0.132 ms
// on a real 1152 x 4096 serving group (8-lane path), the time of 4 of its
// rows alone, so the chain (~32 ns, ~57 cycles a sample) is all of it;
// 0.157 ms on the synthetic group of orders 0-32 (32-lane path, whose
// ~1.1k warps compete for the warp schedulers).  3.3-3.9x the first design.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 32;
constexpr int kNarrow = 8;              // lanes a row on the narrow path
constexpr int kRows = 4;                // rows a block, one warp each
constexpr int kPiece = 128;             // samples of a row staged at a time
constexpr int kSlice = 3 * kPiece + 8;  // two residual pieces, one output
                                        // piece; +8 words spreads the four
                                        // narrow rows over all 32 banks
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// c + a * b as one signed IMAD.WIDE (for the C++ product of two
// sign-extended int64s the compiler emits an unsigned IMAD.WIDE and sign
// fix-ups, three more dependent instructions in the chain).
__device__ __forceinline__ int64_t mad_wide(int32_t a, int32_t b,
                                            int64_t c) {
  int64_t d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// One block of G outputs of the row this lane's segment holds; returns
// lane k's output.  kWarm: some output of the block may be a warm-up one.
template <int G, bool kWarm>
__device__ __forceinline__ int32_t block_of(int64_t& acc, const int32_t (&w)[G],
                                            int32_t rv, int sh, int k,
                                            bool warm) {
  int32_t mine = 0;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    // int32 wrap of r + floor(acc / 2^shift): the low word of the
    // arithmetic shift (shift < 32) is one funnel shift
    const uint64_t a = static_cast<uint64_t>(acc);
    int32_t v = static_cast<int32_t>(
        static_cast<uint32_t>(rv) +
        __funnelshift_r(static_cast<uint32_t>(a),
                        static_cast<uint32_t>(a >> 32), sh));
    if (kWarm && warm) v = rv;
    const int32_t sj = __shfl_sync(kFull, v, j, G);
    if (k == j) {
      mine = sj;
      acc = 0;
    }
    acc = mad_wide(w[j], sj, acc);
  }
  return mine;
}

// Synthesises one row on a segment of G lanes (the whole warp, or a quarter
// of it); `slice` is the row's shared memory.  Rows past B (valid false)
// only take part in the segment's shuffles.
template <int G, bool kVec>
__device__ __forceinline__ void synth(const int32_t* __restrict__ data,
                                      const int32_t* __restrict__ coeffs,
                                      const int32_t* __restrict__ shift,
                                      const int32_t* __restrict__ order,
                                      int32_t* __restrict__ out, int64_t row,
                                      bool valid, int N, int32_t* slice) {
  const int k = threadIdx.x & (G - 1);
  const int32_t* r = data + row * N;
  int32_t* s = out + row * N;
  int32_t* rbuf = slice;
  int32_t* obuf = slice + 2 * kPiece;
  const int32_t ck = valid ? coeffs[row * kMaxOrder + k] : 0;
  int32_t w[G];
#pragma unroll
  for (int j = 0; j < G; ++j)
    w[j] = __shfl_sync(kFull, ck, (k - 1 - j) & (G - 1), G);
  const int sh = valid ? shift[row] : 0;
  const int ord = valid ? order[row] : 0;
  const int warm_end = __reduce_max_sync(kFull, ord);
  const int pieces = (N + kPiece - 1) / kPiece;

  auto fetch = [&](int p) {
    if (p < pieces) {
      int32_t* dst = rbuf + (p & 1) * kPiece;
      const int base = p * kPiece;
      if (kVec) {
        for (int q = k; q < kPiece / 4; q += G) {
          const int e = base + 4 * q;
          const bool in = valid && e < N;
          cp_async16(dst + 4 * q, in ? r + e : data, in ? 16 : 0);
        }
      } else {
        for (int q = k; q < kPiece; q += G) {
          const int e = base + q;
          const bool in = valid && e < N;
          cp_async4(dst + q, in ? r + e : data, in ? 4 : 0);
        }
      }
    }
    cp_commit();  // an empty group past the end keeps the count uniform
  };

  fetch(0);
  fetch(1);
  int64_t acc = 0;
  for (int p = 0; p < pieces; ++p) {
    cp_wait<1>();  // piece p has landed
    __syncwarp();
    const int32_t* rp = rbuf + (p & 1) * kPiece;
    const int len = min(kPiece, N - p * kPiece);
    for (int b = 0; b < len; b += G) {
      const int n0 = p * kPiece + b;
      const int32_t rv = rp[b + k];
      obuf[b + k] =
          n0 < warm_end
              ? block_of<G, true>(acc, w, rv, sh, k, n0 + k < ord)
              : block_of<G, false>(acc, w, rv, sh, k, false);
    }
    __syncwarp();
    if (kVec) {
      for (int q = k; q < kPiece / 4; q += G) {
        const int e = p * kPiece + 4 * q;
        if (valid && e < N)
          *reinterpret_cast<int4*>(s + e) =
              *reinterpret_cast<const int4*>(obuf + 4 * q);
      }
    } else {
      for (int q = k; q < kPiece; q += G) {
        const int e = p * kPiece + q;
        if (valid && e < N) s[e] = obuf[q];
      }
    }
    fetch(p + 2);  // into the buffer piece p was read from
  }
  cp_wait<0>();
}

template <bool kVec>
__global__ void __launch_bounds__(kRows * 32)
lpc_rows(const int32_t* __restrict__ data, const int32_t* __restrict__ coeffs,
         const int32_t* __restrict__ shift, const int32_t* __restrict__ order,
         int32_t* __restrict__ out, int B, int N) {
  __shared__ __align__(16) int32_t sm[kRows * kSlice];
  __shared__ int wide_rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t row = row0 + warp;
  const bool valid = row < B;
  if (threadIdx.x == 0) wide_rows = 0;
  __syncthreads();
  const int32_t c = valid ? coeffs[row * kMaxOrder + lane] : 0;
  if (__any_sync(kFull, lane >= kNarrow && c != 0) && lane == 0)
    wide_rows = 1;
  __syncthreads();
  if (!wide_rows) {
    if (warp == 0) {
      const int seg = lane / kNarrow;
      synth<kNarrow, kVec>(data, coeffs, shift, order, out, row0 + seg,
                           row0 + seg < B, N, sm + seg * kSlice);
    }
    return;
  }
  if (valid)
    synth<32, kVec>(data, coeffs, shift, order, out, row, true, N,
                    sm + warp * kSlice);
}

}  // namespace

extern "C" int ohp_lpc_synthesize(const int32_t* data, const int32_t* coeffs,
                                  const int32_t* shift, const int32_t* order,
                                  int32_t* out, int B, int N,
                                  cudaStream_t stream) {
  if (B > 0 && N > 0) {
    const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
    const bool vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(data) |
                                     reinterpret_cast<uintptr_t>(out)) %
                                            16 ==
                                        0;
    if (vec)
      lpc_rows<true><<<blocks, kRows * 32, 0, stream>>>(data, coeffs, shift,
                                                        order, out, B, N);
    else
      lpc_rows<false><<<blocks, kRows * 32, 0, stream>>>(data, coeffs, shift,
                                                         order, out, B, N);
  }
  return static_cast<int>(cudaGetLastError());
}
