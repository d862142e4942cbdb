// Packed one-vs-many matcher: query words [B, Sq, W] x library words
// [L, Sl, W] (+ counts) -> [B, L] f32 scores, by AND + __popc.
//
// Replaces the TPU kernel lbaudiodetective_tpu/ops/pallas/match_fused.py
// :: match_one_vs_many_fused, and with it the XLA packed matcher whose
// scores it equals (ops/match_packed.py :: match_one_vs_many_packed).
//
// Score (quirks Q10/Q11, LBAudioDetectiveFingerprint.m:119-176).  With the
// words masked to the first `mask_pairs` pairs,
//     hits(j, i) = popc(Pl_j & Pq_i) + popc(Nl_j & Nq_i)
//     inv(row)   = 1 / popc(P_row | N_row), 0 where the row has no bit,
// the longer side slides over the shorter one:
//   A (n_lib >= n_q): D(o) = sum_{i < n_q}   hits(o+i, i) * inv_lib(o+i),
//                     o <= n_lib - n_q, mean D(o) / n_q;
//   B (n_lib <  n_q): D(o) = sum_{i < n_lib} hits(i, o+i) * inv_q(o+i),
//                     o <= n_q - n_lib, mean D(o) / n_lib.
// The score is the max mean; 0 when either count is 0.  Only the
// orientation the reference selects is computed.
//
// Bound on the H100: device memory for the library's valid rows (1.78 GB
// for a 1M-entry library of 31-80 rows, 0.53 ms at 3.35 TB/s), and the
// CUDA cores' __popc (16 a clock an SM): a full 1M scan needs ~2.7 G of
// them at W = 4 (one a compared word), about the time of its bytes.
//
// Design: persistent CTAs, a few an SM, each reading every library entry
// once a launch.
//  - A CTA stages its query group's rows (all B x Sq rows, or a group of
//    them when they do not fit; the grid's second axis walks the groups)
//    masked, with inv_q, in shared memory once.
//  - It walks the library in chunks of E entries (blockIdx.x, then a grid
//    stride).  Each chunk's valid rows arrive by cp.async, 16 bytes at a time
//    where the rows allow, into a double buffer: the next chunk loads while
//    this one is scored.  The chunk's counts come a chunk ahead of its
//    rows, so no thread waits on a global load to issue a copy.  inv_lib is
//    computed once an entry row, a warp an entry, from a table of
//    __fdiv_rn(1, c): no row divides.  Chunks hold up to 64 entries, and
//    where shared memory lets four CTAs share an SM (a search's coarse
//    pass) the register budget is sized for four.
//  - Work items are (query, entry, offset) chains, numbered through a
//    prefix sum over the chunk's (query, entry) pairs and spread over all
//    of the CTA's threads, so short compares with few offsets do not idle
//    lanes.  Neighbouring threads take neighbouring offsets of one pair:
//    they read neighbouring library rows and, in orientation A, one query
//    row.  Words are read as 16- or 8-byte vectors; only the first
//    ceil(mask_pairs / 32) words of a row are compared.
//  - Pos and neg bits of a fingerprint row are disjoint, so (Pl & Pq) and
//    (Nl & Nq) share no bit and popc((Pl & Pq) | (Nl & Nq)) is their hit
//    count: one popc a word, half the reference's.  An entry and a query
//    that both hold a row with a bit in both planes take two.
//  - Each chain adds its diagonal in order in f32 (explicit _rn operations:
//    no FMA contraction, IEEE division), so scores are bit-equal to the
//    plain version and the JAX package.  The max over offsets is an
//    atomicMax on the scores' bits (scores are >= +0, so their bits order
//    as they do), which is exact in any order: two runs give identical
//    bits, and a score depends on its entry and query alone, whatever
//    library or chunk it is computed in.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// 0 in the library the port loads.  scripts/torch_match_ablation.py builds
// copies with bits set, each switching one step off to time what it costs
// (their scores are wrong): 1 the chains' sums, 2 inv_lib and the overlap
// flags, 4 the row copies, 8 the work items (search, chains, max).
#ifndef LBAD_MATCH_SKIP
#define LBAD_MATCH_SKIP 0
#endif
constexpr int kSkip = LBAD_MATCH_SKIP;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr long long round4(long long n) { return (n + 3) / 4 * 4; }

// Shared-memory plan, in 4-byte words (every region a multiple of 16 bytes):
//   qp, qn  [bg * sq * w]          the group's query rows, masked
//   inv_q   [bg * sq] f32
//   nq      [2 * bg]               counts, then 1 for a query with a row
//                                  that has a bit in both planes
//   2 x { lp, ln [e * sl * w]      a chunk's entry rows (valid rows only)
//         inv_l  [e * sl] f32
//         nl     [2 * e] }         counts, then the same flag an entry
//   cnt     [2][e]                 raw counts of the next two chunks
//   best    [bg * e]               max score bits of each (query, entry)
//   pre     [bg * e + 1]           prefix sum of the pairs' offset counts
//   recip   [32 * w + 1] f32       1 / c for each possible-hit count c
struct Layout {
  long long qp, qn, inv_q, nq, buf, buf_words, lp, ln, inv_l, nl, cnt, best, pre, recip,
      total;
};

__host__ __device__ Layout layout(int bg, int sq, int e, int sl, int w) {
  Layout l;
  const long long q_rows = static_cast<long long>(bg) * sq;
  const long long l_rows = static_cast<long long>(e) * sl;
  l.qp = 0;
  l.qn = l.qp + round4(q_rows * w);
  l.inv_q = l.qn + round4(q_rows * w);
  l.nq = l.inv_q + round4(q_rows);
  l.buf = l.nq + round4(2LL * bg);
  l.lp = 0;                                          // offsets inside a buffer
  l.ln = l.lp + round4(l_rows * w);
  l.inv_l = l.ln + round4(l_rows * w);
  l.nl = l.inv_l + round4(l_rows);
  l.buf_words = l.nl + round4(2LL * e);
  l.cnt = l.buf + 2 * l.buf_words;
  l.best = l.cnt + round4(2LL * e);
  l.pre = l.best + round4(static_cast<long long>(bg) * e);
  l.recip = l.pre + round4(static_cast<long long>(bg) * e + 1);
  l.total = l.recip + round4(32LL * w + 1);
  return l;
}

__device__ __forceinline__ unsigned word_mask(int k, int mask_pairs) {
  const int lo = 32 * k;
  if (mask_pairs >= lo + 32) return 0xFFFFFFFFu;
  if (mask_pairs <= lo) return 0u;
  return (1u << (mask_pairs - lo)) - 1u;
}

// 1 / popc(P | N) over the compared words of one row (nv vectors of V
// words, masked), 0 for a row with no bit: recip[c] holds __fdiv_rn(1, c),
// recip[0] 0.  Sets `overlap` when a compared pair is set in both planes.
template <int V>
__device__ __forceinline__ float row_inv(const unsigned* p, const unsigned* n, int nv,
                                         int mask_pairs, const float* recip, bool& overlap) {
  int c = 0;
  unsigned o = 0;
  for (int v = 0; v < nv; ++v) {
    unsigned a[V], b[V];
    if constexpr (V == 4) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[v];
      const uint4 y = reinterpret_cast<const uint4*>(n)[v];
      a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
      b[0] = y.x; b[1] = y.y; b[2] = y.z; b[3] = y.w;
    } else if constexpr (V == 2) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[v];
      const uint2 y = reinterpret_cast<const uint2*>(n)[v];
      a[0] = x.x; a[1] = x.y;
      b[0] = y.x; b[1] = y.y;
    } else {
      a[0] = p[v];
      b[0] = n[v];
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const unsigned m = word_mask(V * v + k, mask_pairs);
      c += __popc((a[k] | b[k]) & m);
      o |= a[k] & b[k] & m;
    }
  }
  overlap = o != 0;
  return recip[c];
}

// popc(p & q) + popc(n & r) of one word, by one popc when kOne says the
// two AND sets share no bit.
template <bool kOne>
__device__ __forceinline__ int word_hits(unsigned p, unsigned q, unsigned n, unsigned r) {
  if constexpr (kOne) {
    return __popc((p & q) | (n & r));
  } else {
    return __popc(p & q) + __popc(n & r);
  }
}

// Hits of one library row against one query row, over nv vectors of V
// words (the query's words past the mask are zero).  kOne: the library
// row or the query row has no bit set in both its planes, so that
// (Pl & Pq) and (Nl & Nq) share no bit and one popc counts both.
template <int V, bool kOne>
__device__ __forceinline__ int row_hits(const unsigned* lp, const unsigned* ln,
                                        const unsigned* qp, const unsigned* qn, int nv) {
  int h = 0;
  for (int v = 0; v < nv; ++v) {
    if constexpr (V == 4) {
      const uint4 a = reinterpret_cast<const uint4*>(lp)[v];
      const uint4 b = reinterpret_cast<const uint4*>(qp)[v];
      const uint4 c = reinterpret_cast<const uint4*>(ln)[v];
      const uint4 d = reinterpret_cast<const uint4*>(qn)[v];
      h += word_hits<kOne>(a.x, b.x, c.x, d.x) + word_hits<kOne>(a.y, b.y, c.y, d.y)
           + word_hits<kOne>(a.z, b.z, c.z, d.z) + word_hits<kOne>(a.w, b.w, c.w, d.w);
    } else if constexpr (V == 2) {
      const uint2 a = reinterpret_cast<const uint2*>(lp)[v];
      const uint2 b = reinterpret_cast<const uint2*>(qp)[v];
      const uint2 c = reinterpret_cast<const uint2*>(ln)[v];
      const uint2 d = reinterpret_cast<const uint2*>(qn)[v];
      h += word_hits<kOne>(a.x, b.x, c.x, d.x) + word_hits<kOne>(a.y, b.y, c.y, d.y);
    } else {
      h += word_hits<kOne>(lp[v], qp[v], ln[v], qn[v]);
    }
  }
  return h;
}

// h (0 <= h < 2^23) as a float, exactly: 2^23 + h has h in its mantissa.
// Two full-rate operations instead of a conversion at 16 a clock an SM,
// the rate of the __popc it follows.
__device__ __forceinline__ float small_int_to_float(int h) {
  return __fsub_rn(__int_as_float(0x4B000000 + h), 8388608.0f);
}

// One chain: sum_i hits(row i) * inv[i] in order, in f32 with _rn
// operations (rows w words apart).
template <int V, bool kOne>
__device__ __forceinline__ float chain_sum(const unsigned* lp, const unsigned* ln,
                                           const unsigned* qp, const unsigned* qn,
                                           const float* inv, int n, int w, int nv) {
  float acc = 0.0f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float h = small_int_to_float(
        row_hits<V, kOne>(lp + i * w, ln + i * w, qp + i * w, qn + i * w, nv));
    acc = __fadd_rn(acc, __fmul_rn(h, inv[i]));
  }
  return acc;
}


__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(d), "l"(src) : "memory");
}

// kCtas: CTAs an SM the register budget is sized for (4 where the shared
// memory lets four share an SM, as in a search's coarse pass).
template <int V, int kCtas>
__global__ void __launch_bounds__(kThreads, kCtas)
match_packed_kernel(const unsigned* __restrict__ q_pos, const unsigned* __restrict__ q_neg,
                    const int* __restrict__ n_q, int batch, int sq,
                    const unsigned* __restrict__ lib_pos, const unsigned* __restrict__ lib_neg,
                    const int* __restrict__ n_lib, long long n_entries, int sl, int w, int wu,
                    int mask_pairs, int bg, int e_chunk, bool vec16, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned smem[];
  const Layout lay = layout(bg, sq, e_chunk, sl, w);
  unsigned* qp = smem + lay.qp;
  unsigned* qn = smem + lay.qn;
  float* inv_q = reinterpret_cast<float*>(smem + lay.inv_q);
  int* nq = reinterpret_cast<int*>(smem + lay.nq);
  int* best = reinterpret_cast<int*>(smem + lay.best);
  int* pre = reinterpret_cast<int*>(smem + lay.pre);
  float* recip = reinterpret_cast<float*>(smem + lay.recip);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nv = (wu + V - 1) / V;
  const int n_pairs = bg * e_chunk;
  const int e_shift = __ffs(e_chunk) - 1;            // e_chunk is a power of two

  // ---- the group's query rows, masked, and their inv_q -------------------
  const int b0 = blockIdx.y * bg;
  const int nb = min(bg, batch - b0);
  const size_t q_off = static_cast<size_t>(b0) * sq * w;
  for (int idx = tid; idx < nb * sq * w; idx += kThreads) {
    const unsigned m = word_mask(idx % w, mask_pairs);
    qp[idx] = q_pos[q_off + idx] & m;
    qn[idx] = q_neg[q_off + idx] & m;
  }
  int* q_overlap = nq + bg;
  for (int c = tid; c <= 32 * wu; c += kThreads) {
    recip[c] = c > 0 ? __fdiv_rn(1.0f, static_cast<float>(c)) : 0.0f;
  }
  for (int b = tid; b < bg; b += kThreads) {
    nq[b] = b < nb ? min(max(n_q[b0 + b], 0), sq) : 0;
    q_overlap[b] = 0;
  }
  __syncthreads();
  for (int j = tid; j < nb * sq; j += kThreads) {
    bool overlap;
    inv_q[j] = row_inv<V>(qp + j * w, qn + j * w, nv, mask_pairs, recip, overlap);
    if (overlap) q_overlap[j / sq] = 1;
  }
  __syncthreads();
  // An entry's inv_lib is read only where some query slides over it (its
  // count >= the query's), and its overlap flag only where a query has a
  // row with a pair in both planes.
  int nq_min = sq + 1, any_q_overlap = 0;
  for (int b = 0; b < nb; ++b) {
    if (nq[b] > 0) nq_min = min(nq_min, nq[b]);
    any_q_overlap |= q_overlap[b];
  }

  // The library streams through in a pipeline one chunk deep: each
  // cp.async group holds the valid rows of the next chunk and the counts of
  // the one after.
  const long long n_chunks = (n_entries + e_chunk - 1) / e_chunk;
  int* cnt = reinterpret_cast<int*>(smem + lay.cnt);
  // Copies chunk c's valid rows into buffer `buf`, their counts taken from
  // count slot `slot`, and records the clamped counts there.
  auto copy_rows = [&](long long c, int buf, int slot) {
    unsigned* base = smem + lay.buf + buf * lay.buf_words;
    int* nl = reinterpret_cast<int*>(base + lay.nl);
    for (int e = warp; e < e_chunk; e += kWarps) {
      const long long l = c * e_chunk + e;
      const int n = c < n_chunks && l < n_entries ? min(max(cnt[slot * e_chunk + e], 0), sl) : 0;
      if (lane == 0) {
        nl[e] = n;
        nl[e_chunk + e] = 0;                         // overlap flag, set below
      }
      const size_t src = static_cast<size_t>(l) * sl * w;
      unsigned* dp = base + lay.lp + static_cast<size_t>(e) * sl * w;
      unsigned* dn = base + lay.ln + static_cast<size_t>(e) * sl * w;
      const int words = (kSkip & 4) ? 0 : n * w;
      if (vec16) {
        for (int u = 4 * lane; u < words; u += 128) {
          cp_async16(dp + u, lib_pos + src + u);
          cp_async16(dn + u, lib_neg + src + u);
        }
      } else {
        for (int u = lane; u < words; u += 32) {
          cp_async4(dp + u, lib_pos + src + u);
          cp_async4(dn + u, lib_neg + src + u);
        }
      }
    }
  };
  // Copies chunk c's raw counts into count slot `slot`.
  auto copy_counts = [&](long long c, int slot) {
    const long long l = c * e_chunk + tid;
    if (tid < e_chunk && c < n_chunks && l < n_entries) {
      cp_async4(cnt + slot * e_chunk + tid, n_lib + l);
    }
  };

  const long long c0 = blockIdx.x;
  for (int e = tid; e < e_chunk; e += kThreads) {
    const long long l = c0 * e_chunk + e;
    cnt[e] = l < n_entries ? __ldg(n_lib + l) : 0;
  }
  __syncthreads();                                 // counts of c0
  copy_rows(c0, 0, 0);
  copy_counts(c0 + gridDim.x, 1);
  asm volatile("cp.async.commit_group;" ::: "memory");
  int k = 0;
  for (long long c = c0; c < n_chunks; c += gridDim.x, ++k) {
    // Chunk c's rows and the next chunk's counts landed; every thread left
    // the other buffer and the other count slot at the previous chunk.
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    copy_rows(c + gridDim.x, (k + 1) & 1, (k + 1) & 1);
    copy_counts(c + 2LL * gridDim.x, k & 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    unsigned* base = smem + lay.buf + (k & 1) * lay.buf_words;
    const unsigned* lp = base + lay.lp;
    const unsigned* ln = base + lay.ln;
    float* inv_l = reinterpret_cast<float*>(base + lay.inv_l);
    int* nl = reinterpret_cast<int*>(base + lay.nl);
    int* l_overlap = nl + e_chunk;

    // inv_lib and the overlap flag of each entry: a warp an entry, a lane a
    // row.
    for (int e = warp; e < e_chunk; e += kWarps) {
      const int n = (kSkip & 2) || (nl[e] < nq_min && !any_q_overlap) ? 0 : nl[e];
      bool overlap = false;
      for (int j = lane; j < n; j += 32) {
        const size_t row = static_cast<size_t>(e) * sl + j;
        bool o;
        inv_l[row] = row_inv<V>(lp + row * w, ln + row * w, nv, mask_pairs, recip, o);
        overlap = overlap || o;
      }
      if (__any_sync(0xFFFFFFFFu, overlap) && lane == 0) l_overlap[e] = 1;
    }
    // Offsets of each (query, entry) pair; pair p = b * e_chunk + e.
    for (int p = tid; p < n_pairs; p += kThreads) {
      const int b = p >> e_shift;
      const int nqb = nq[b], nle = nl[p - (b << e_shift)];
      pre[p + 1] = nqb > 0 && nle > 0 ? abs(nle - nqb) + 1 : 0;
      best[p] = 0;                                 // the bits of +0.0f
    }
    __syncthreads();
    if (warp == 0) {                               // inclusive scan of pre[1..]
      int running = 0;
      for (int s = 0; s < n_pairs; s += 32) {
        int v = s + lane < n_pairs ? pre[s + lane + 1] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int x = __shfl_up_sync(0xFFFFFFFFu, v, d);
          if (lane >= d) v += x;
        }
        if (s + lane < n_pairs) pre[s + lane + 1] = running + v;
        running += __shfl_sync(0xFFFFFFFFu, v, 31);
      }
      if (lane == 0) pre[0] = 0;
    }
    __syncthreads();

    const int n_items = (kSkip & 8) ? 0 : pre[n_pairs];
    for (int t = tid; t < n_items; t += kThreads) {
      int lo = 0, hi = n_pairs;                    // pre[lo] <= t < pre[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (pre[mid] <= t) lo = mid; else hi = mid;
      }
      const int p = lo, o = t - pre[p];
      const int b = p >> e_shift, e = p - (b << e_shift);
      const int nqb = nq[b], nle = nl[e];
      const bool slide_lib = nle >= nqb;           // orientation A
      const int n = slide_lib ? nqb : nle;
      const size_t l_row = static_cast<size_t>(e) * sl + (slide_lib ? o : 0);
      const size_t q_row = static_cast<size_t>(b) * sq + (slide_lib ? 0 : o);
      const unsigned* lpr = lp + l_row * w;
      const unsigned* lnr = ln + l_row * w;
      const unsigned* qpr = qp + q_row * w;
      const unsigned* qnr = qn + q_row * w;
      const float* inv = slide_lib ? inv_l + static_cast<size_t>(e) * sl + o
                                   : inv_q + static_cast<size_t>(b) * sq + o;
      const float acc = (kSkip & 1) ? 0.0f
                        : l_overlap[e] && q_overlap[b]
                            ? chain_sum<V, false>(lpr, lnr, qpr, qnr, inv, n, w, nv)
                            : chain_sum<V, true>(lpr, lnr, qpr, qnr, inv, n, w, nv);
      atomicMax(best + p, __float_as_int(__fdiv_rn(acc, static_cast<float>(n))));
    }
    __syncthreads();                               // best complete; buffer k free
    for (int p = tid; p < nb * e_chunk; p += kThreads) {
      const int b = p >> e_shift;
      const long long l = c * e_chunk + (p - (b << e_shift));
      if (l < n_entries) out[static_cast<size_t>(b0 + b) * n_entries + l] = __int_as_float(best[p]);
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <int V, int kCtas>
int launch(const unsigned* q_pos, const unsigned* q_neg, const int* n_q, int batch, int sq,
           const unsigned* lib_pos, const unsigned* lib_neg, const int* n_lib,
           long long n_entries, int sl, int w, int wu, int mask_pairs, int bg, int e_chunk,
           bool vec16, float* out, int smem, cudaStream_t stream) {
  auto kernel = match_packed_kernel<V, kCtas>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_chunks = (n_entries + e_chunk - 1) / e_chunk;
  const int groups = (batch + bg - 1) / bg;
  const long long ctas = (static_cast<long long>(max(per_sm, 1)) * sms + groups - 1) / groups;
  const dim3 grid(static_cast<unsigned>(min(n_chunks, max(ctas, 1LL))),
                  static_cast<unsigned>(groups));
  kernel<<<grid, kThreads, smem, stream>>>(q_pos, q_neg, n_q, batch, sq, lib_pos, lib_neg, n_lib,
                                           n_entries, sl, w, wu, mask_pairs, bg, e_chunk, vec16,
                                           out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory a CTA needs for query groups of `bg`
// queries of `sq` rows and chunks of `e` entries of `sl` rows, W = w.
extern "C" long long lbad_match_packed_smem_bytes(int bg, int sq, int e, int sl, int w) {
  return layout(bg, sq, e, sl, w).total * 4;
}

// Scores [batch, n_entries] into out.  bg queries a CTA (the grid's second
// axis walks ceil(batch / bg) groups), e_chunk (a power of two) entries a
// chunk, and the
// register budget sized for `ctas` CTAs an SM (4, else 2); the persistent
// grid is min(chunks, CTAs the card holds at once / groups).
extern "C" int lbad_match_packed(const int* q_pos, const int* q_neg, const int* n_q,
                                 int batch, int sq, const int* lib_pos,
                                 const int* lib_neg, const int* n_lib,
                                 long long n_entries, int sl, int w, int mask_pairs,
                                 int bg, int e_chunk, int ctas, float* out, void* stream) {
  if (batch < 0 || sq < 0 || sl < 0 || w < 1 || mask_pairs < 0 || bg < 1 || e_chunk < 1
      || (e_chunk & (e_chunk - 1)) != 0 || n_entries < 0 || (batch + bg - 1) / bg > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || n_entries == 0) return static_cast<int>(cudaGetLastError());
  const int wu = min(w, (mask_pairs + 31) / 32);
  const long long smem = lbad_match_packed_smem_bytes(bg, sq, e_chunk, sl, w);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec16 = (static_cast<long long>(sl) * w) % 4 == 0
                     && (reinterpret_cast<uintptr_t>(lib_pos) & 15u) == 0
                     && (reinterpret_cast<uintptr_t>(lib_neg) & 15u) == 0;
  using Launch = int (*)(const unsigned*, const unsigned*, const int*, int, int,
                         const unsigned*, const unsigned*, const int*, long long, int, int,
                         int, int, int, int, bool, float*, int, cudaStream_t);
  const bool four = ctas >= 4;
  const Launch fn = w % 4 == 0 && wu > 2 ? (four ? launch<4, 4> : launch<4, 2>)
                    : w % 2 == 0 && wu > 1 ? (four ? launch<2, 4> : launch<2, 2>)
                                           : (four ? launch<1, 4> : launch<1, 2>);
  return fn(reinterpret_cast<const unsigned*>(q_pos), reinterpret_cast<const unsigned*>(q_neg),
            n_q, batch, sq, reinterpret_cast<const unsigned*>(lib_pos),
            reinterpret_cast<const unsigned*>(lib_neg), n_lib, n_entries, sl, w, wu, mask_pairs,
            bg, e_chunk, vec16, out, static_cast<int>(smem), static_cast<cudaStream_t>(stream));
}
