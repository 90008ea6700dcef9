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
// What bounds it on this card: the chain, not bytes.  A row is ~5 KB of
// input, but each active bin waits for the one before it, and a serving
// group has only ~10^2 pooled rows.  The first design (one thread per
// pooled row walking both passes bin by bin, 16-bin chunks loaded one chunk
// ahead) ran 2 x 1024 dependent steps a row behind global loads that two
// warps on the card could not hide: 0.143 ms on AAC group 0 (92 live rows)
// and 0.305 ms on a 1024-row worst case, against 0.3 and 3.2 us to move the
// bytes (H100 80GB HBM3, 700 W).
//
// Design: the reset rule cuts a row into runs, maximal stretches of one
// active slot byte.  Runs are disjoint and each starts from a zero history,
// so an upward and a downward run never share a bin and the two passes
// commute: every run of a row, in either direction, is an independent
// chain.
//   - One warp per pooled row.  Its 1024 floats, 1024 slot bytes and 24 x
//     12 coefficients go to shared memory in one round of 16-byte cp.async
//     copies (its 24 direction bytes by plain loads); from then on no step
//     of a chain touches global memory, and the row goes back as 16-byte
//     coalesced stores.
//   - The runs are found with ballots over the slot bytes (32 bins a
//     ballot): one bitmap of run starts, one of run ends, each ranked with
//     a warp scan into a list.  A slot that appears in two stretches is two
//     runs; a slot byte above 24, or a direction other than 0 or 1, is
//     inactive.
//   - A lane walks a run in its direction with the 12-tap history in a
//     register ring (whole groups of 12 bins as straight-line code, the
//     next 12 inputs read ahead), the taps summed oldest first, so one FMA
//     and a subtraction wait for the previous output.  That is the first
//     design's order: summing taps 2-11 in two chains measured 1.22e-5 of a
//     worst-case row's peak against the plain version, past the 1e-5 bound.
//   - Runs of up to kLong bins are walked whole, one lane each.  A longer run
//     (group 0's reach 848 bins) is cut into K chunks of 32.  The filter is
//     linear, so with S[k] the run's last 12 outputs before chunk k:
//       1. one lane per chunk: chunk 0 from a zero history (final), chunks
//          1..K-2 from a zero history for their last outputs T0[k], and one
//          lane for the response g to a unit history;
//       2. 12 lanes per cut run build the 12 x 12 zero-input map phi over a
//          chunk from g, then pass the state along: S[k+1] = T0[k] +
//          phi S[k], one matrix-vector step a chunk;
//       3. one lane per chunk walks chunks 1..K-1 again from S[k].
//     The chain of an 848-bin run drops from 848 steps to ~64 plus 25
//     matrix-vector steps.  The rounding differs from a plain walk: phi
//     grows the error of the state it passes by up to its largest absolute
//     row sum, so a run whose phi exceeds kGate is walked whole from chunk
//     0's end instead.  Group 0's cut runs reach 1.94; filters at the
//     encoder's reflection-coefficient limits reach 4-48, and cut with no
//     gate they erred up to 2x the whole walk, past 1e-5 of the row peak
//     (on the float32 model of this kernel, `tns_kernel_model` in
//     tests/test_torch_aac_synthesis.py, which holds it to 1e-5).
//   - A pooled row whose trow is outside [0, TB) is padding: its warp
//     leaves before its first load.  The grid has one warp per pooled row,
//     two to a block.
// Measured (H100 80GB HBM3, 700 W; tools/kernel_ab.py, PERF.md): 0.0128 ms
// on AAC group 0, the time of its slowest row alone (the chain floor),
// 0.0186 without the cut; 0.0099 ms on the worst case; 11x and 31x the
// first design.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 1024;
constexpr int kSlots = 24;
constexpr int kOrder = 12;
constexpr int kWarps = 2;                   // pooled rows a block
constexpr int kChunk = 32;                  // bins of a chunk of a cut run
constexpr int kLong = 128;                  // runs longer than this are cut
static_assert(kLong >= 2 * kChunk, "a cut run has three chunks or more");
constexpr int kMaxCut = kBins / (kLong + 1);  // cut runs a row can hold
constexpr int kMaxStates = kBins / kChunk;    // >= the sum of K - 2
constexpr float kGate = 4.0f;
constexpr unsigned kFull = 0xffffffffu;

struct __align__(16) RowSmem {
  float x[kBins];
  float co[kSlots * kOrder];
  float state[kMaxStates][kOrder];  // T0[k], then S[k + 1], of chunks 1..K-2
  float g[kMaxCut][kChunk];         // each cut run's unit-history response
  uint8_t f[kBins];
  uint8_t dir[32];
  uint16_t lo[kBins];  // first bin of each run, in bin order
  uint16_t hi[kBins];  // last bin of each run
  uint16_t cut_run[kMaxCut];  // the cut runs' indices
  uint16_t cut_a[kMaxCut];    // first of each cut run's extra tasks, step 1
  uint16_t cut_c[kMaxCut];    // first of each cut run's tasks, step 3
  uint8_t cut_k[kMaxCut];     // chunks
  uint8_t cut_ok[kMaxCut];    // phi within kGate
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Sum of v over the lanes below this one.
__device__ __forceinline__ int scan_before(int v, int lane) {
  int n = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, n, off);
    if (lane >= off) n += t;
  }
  return n - v;
}

__device__ __forceinline__ bool active(const RowSmem& m, int i) {
  const int f = m.f[i];
  return f > 0 && f <= kSlots && m.dir[f - 1] <= 1;
}

// A stretch [p0, p1) of a run, positions counted in the run's direction
// (bin first + p * step), with its inputs (m.x, or zero) and where its
// outputs go: back to m.x, the last 12 (newest first) to tail, every one
// to seq[p - p0].
struct Walk {
  int first, step, p0, p1;
  bool zero_in, to_x;
  float* tail;
  float* seq;
};

struct Run {
  int first, step, len;
  float c[kOrder];
};

__device__ __forceinline__ Run run_of(const RowSmem& m, int k) {
  const int lo = m.lo[k], hi = m.hi[k], slot = m.f[lo] - 1;
  const bool down = m.dir[slot] == 1;
  Run r{down ? hi : lo, down ? -1 : 1, hi - lo + 1, {}};
#pragma unroll
  for (int t = 0; t < kOrder; ++t) r.c[t] = m.co[slot * kOrder + t];
  return r;
}

// Walks w from the history init (init[t]: the output t + 1 steps before
// w.p0) with coefficients c.
__device__ __forceinline__ void walk(RowSmem& m, const float (&c)[kOrder],
                                     const float (&init)[kOrder],
                                     const Walk& w) {
  const int len = w.p1 - w.p0;
  float h[kOrder], in[kOrder];
  auto input = [&](int q) {
    return !w.zero_in && q < len ? m.x[w.first + (w.p0 + q) * w.step]
                                 : 0.0f;
  };
#pragma unroll
  for (int t = 0; t < kOrder; ++t) {
    h[kOrder - 1 - t] = init[t];
    in[t] = input(t);
  }
  // position q sits at ring slot u = q mod 12; h[(u - 1 - t) mod 12] holds
  // the output t + 1 steps back
  auto bin = [&](int u, int q) {
    float acc = 0.0f;
#pragma unroll
    for (int t = kOrder - 1; t >= 0; --t)
      acc = fmaf(c[t], h[(u + kOrder - 1 - t) % kOrder], acc);
    const float y = in[u] - acc;
    h[u] = y;
    if (w.to_x) m.x[w.first + (w.p0 + q) * w.step] = y;
    if (w.tail && q >= len - kOrder) w.tail[len - 1 - q] = y;
    if (w.seq) w.seq[q] = y;
  };
  int q0 = 0;
  // whole groups of 12 bins as straight-line code, so the compiler can
  // start a bin's older taps while earlier bins finish; the next 12 inputs
  // are read before this group's outputs are written, so no shared-memory
  // load waits in the chain
  for (; q0 + kOrder <= len; q0 += kOrder) {
    float next[kOrder];
#pragma unroll
    for (int u = 0; u < kOrder; ++u) next[u] = input(q0 + kOrder + u);
#pragma unroll
    for (int u = 0; u < kOrder; ++u) bin(u, q0 + u);
#pragma unroll
    for (int u = 0; u < kOrder; ++u) in[u] = next[u];
  }
#pragma unroll
  for (int u = 0; u < kOrder - 1; ++u)
    if (q0 + u < len) bin(u, q0 + u);
}

// The cut run whose tasks, numbered from `at` (cut_a or cut_c), hold t.
__device__ __forceinline__ int cut_of(const uint16_t* at, int ncut, int t) {
  int q = 0;
  while (q + 1 < ncut && at[q + 1] <= t) ++q;
  return q;
}

__global__ void __launch_bounds__(kWarps * 32)
tns_rows(float* __restrict__ spec, int64_t TB,
         const uint8_t* __restrict__ tfi, const float* __restrict__ tco,
         const uint8_t* __restrict__ tdir, const int32_t* __restrict__ trow,
         int64_t P) {
  __shared__ RowSmem rows[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (j >= P) return;
  const int64_t r = trow[j];
  if (r < 0 || r >= TB) return;  // padding: the whole warp leaves
  RowSmem& m = rows[warp];
  float* x = spec + r * kBins;

  // stage the row, its slot bytes and its coefficients
  for (int q = lane; q < kBins / 4; q += 32) cp_async16(m.x + 4 * q, x + 4 * q);
  for (int q = lane; q < kBins / 16; q += 32)
    cp_async16(m.f + 16 * q, tfi + j * kBins + 16 * q);
  for (int q = lane; q < kSlots * kOrder / 4; q += 32)
    cp_async16(m.co + 4 * q, tco + j * kSlots * kOrder + 4 * q);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (lane < kSlots) m.dir[lane] = tdir[j * kSlots + lane];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  // run starts and ends, 32 bins a ballot; lane q keeps word q of each
  unsigned starts = 0, ends = 0;
#pragma unroll 4
  for (int q = 0; q < kBins / 32; ++q) {
    const int i = q * 32 + lane;
    const bool a = active(m, i);
    const int f = m.f[i];
    const unsigned s =
        __ballot_sync(kFull, a && (i == 0 || m.f[i - 1] != f));
    const unsigned e =
        __ballot_sync(kFull, a && (i == kBins - 1 || m.f[i + 1] != f));
    if (lane == q) {
      starts = s;
      ends = e;
    }
  }
  // a run may start in one lane's word and end in another's, so the two
  // bitmaps are ranked separately
  const int lo_at = scan_before(__popc(starts), lane);
  const int hi_at = scan_before(__popc(ends), lane);
  const int runs = __shfl_sync(kFull, hi_at + __popc(ends), 31);
  for (int t = lo_at; starts; ++t) {
    m.lo[t] = static_cast<uint16_t>(lane * 32 + __ffs(starts) - 1);
    starts &= starts - 1;
  }
  for (int t = hi_at; ends; ++t) {
    m.hi[t] = static_cast<uint16_t>(lane * 32 + __ffs(ends) - 1);
    ends &= ends - 1;
  }
  __syncwarp();

  // the runs to cut, in run order
  int ncut = 0;
  for (int base = 0; base < runs; base += 32) {
    const int k = base + lane;
    const bool cut = k < runs && m.hi[k] - m.lo[k] + 1 > kLong;
    const unsigned b = __ballot_sync(kFull, cut);
    if (cut) {
      const int q = ncut + __popc(b & ((1u << lane) - 1));
      m.cut_run[q] = static_cast<uint16_t>(k);
      m.cut_k[q] = static_cast<uint8_t>((m.hi[k] - m.lo[k] + kChunk) /
                                        kChunk);
    }
    ncut += __popc(b);
  }
  __syncwarp();
  // step 1: a task per run (a whole run, or a cut run's chunk 0), then each
  // cut run's K - 2 tails and its unit-history response
  const int ea = lane < ncut ? m.cut_k[lane] - 1 : 0;
  const int at = scan_before(ea, lane);
  const int tasks1 = runs + __shfl_sync(kFull, at + ea, 31);
  if (lane < ncut) m.cut_a[lane] = static_cast<uint16_t>(at);
  __syncwarp();
  for (int t = lane; t < tasks1; t += 32) {
    float init[kOrder] = {};
    if (t < runs) {
      const Run u = run_of(m, t);
      walk(m, u.c, init, {u.first, u.step, 0,
                          u.len > kLong ? kChunk : u.len, false, true,
                          nullptr, nullptr});
      continue;
    }
    const int q = cut_of(m.cut_a, ncut, t - runs);
    const int e = t - runs - m.cut_a[q];
    const Run u = run_of(m, m.cut_run[q]);
    if (e < m.cut_k[q] - 2) {  // T0 of chunk e + 1
      walk(m, u.c, init, {u.first, u.step, (e + 1) * kChunk,
                          (e + 2) * kChunk, false, false,
                          m.state[m.cut_a[q] - q + e], nullptr});
    } else {  // g
      init[0] = 1.0f;
      walk(m, u.c, init, {u.first, u.step, 0, kChunk, true, false, nullptr,
                          m.g[q]});
    }
  }
  __syncwarp();

  // step 2: 16 lanes a cut run (two at a time), lane i < 12 holds row i of
  // phi and element i of the state
  {
    const int grp = lane >> 4, i = lane & 15, ii = i < kOrder ? i : 0;
    const unsigned gmask = 0xffffu << (16 * grp);
    for (int q = grp; q < ncut; q += 2) {
      const Run u = run_of(m, m.cut_run[q]);
      float phi[kOrder], norm = 0.0f;
#pragma unroll
      for (int c = 0; c < kOrder; ++c) {
        // the response to unit history c, from g, at position 31 - i
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k + c < kOrder; ++k)
          acc = fmaf(-u.c[k + c], m.g[q][kChunk - 2 - ii - k], acc);
        phi[c] = acc;
        norm += fabsf(acc);
      }
      norm = i < kOrder ? norm : 0.0f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        norm = fmaxf(norm, __shfl_xor_sync(gmask, norm, off, 16));
      const bool ok = norm <= kGate;  // false for a NaN as well
      if (i == 0) m.cut_ok[q] = ok;
      if (!ok) continue;
      float s = m.x[u.first + (kChunk - 1 - ii) * u.step];  // S[1]
      float* st = m.state[m.cut_a[q] - q];
      for (int e = 1; e + 1 < m.cut_k[q]; ++e) {
        float even = 0.0f, odd = 0.0f;
#pragma unroll
        for (int c = 0; c < kOrder; c += 2) {
          even = fmaf(phi[c], __shfl_sync(gmask, s, c, 16), even);
          odd = fmaf(phi[c + 1], __shfl_sync(gmask, s, c + 1, 16), odd);
        }
        float* ent = st + (e - 1) * kOrder;
        s = ent[ii] + (even + odd);
        if (i < kOrder) ent[i] = s;  // S[e + 1] over T0[e]
      }
    }
  }
  __syncwarp();

  // step 3: chunks 1..K-1 of each cut run from their states, or, past the
  // gate, the rest of the run in one walk
  const int ec = lane < ncut ? (m.cut_ok[lane] ? m.cut_k[lane] - 1 : 1) : 0;
  const int ct = scan_before(ec, lane);
  const int tasks3 = __shfl_sync(kFull, ct + ec, 31);
  if (lane < ncut) m.cut_c[lane] = static_cast<uint16_t>(ct);
  __syncwarp();
  for (int t = lane; t < tasks3; t += 32) {
    const int q = cut_of(m.cut_c, ncut, t);
    const int e = t - m.cut_c[q];  // chunk e + 1
    const Run u = run_of(m, m.cut_run[q]);
    float init[kOrder];
    if (e == 0) {
#pragma unroll
      for (int k = 0; k < kOrder; ++k)
        init[k] = m.x[u.first + (kChunk - 1 - k) * u.step];
    } else {
#pragma unroll
      for (int k = 0; k < kOrder; ++k)
        init[k] = m.state[m.cut_a[q] - q + e - 1][k];
    }
    const int p1 = m.cut_ok[q] ? min((e + 2) * kChunk, u.len) : u.len;
    walk(m, u.c, init, {u.first, u.step, (e + 1) * kChunk, p1, false, true,
                        nullptr, nullptr});
  }
  __syncwarp();
  for (int q = lane; q < kBins / 4; q += 32)
    reinterpret_cast<float4*>(x)[q] = reinterpret_cast<const float4*>(m.x)[q];
}

}  // namespace

extern "C" int ohp_tns_apply(float* spec, int64_t TB, const uint8_t* tfi,
                             const float* tco, const uint8_t* tdir,
                             const int32_t* trow, int64_t P,
                             cudaStream_t stream) {
  if (P > 0) {
    const int64_t blocks = (P + kWarps - 1) / kWarps;
    tns_rows<<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
        spec, TB, tfi, tco, tdir, trow, P);
  }
  return static_cast<int>(cudaGetLastError());
}
