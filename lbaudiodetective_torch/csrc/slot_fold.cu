// The pooled live-session fold: the slots that posted add their new
// subfingerprints' hit terms into their running diagonal sums, in place
// (streaming/incremental.py :: IncrementalLibraryMatcher.update_slots).
//
// Replaces no TPU kernel: the JAX package's pool folds with plain jnp (a
// hits einsum over every slot, then per-arrival updates).  The port did the
// same with a bf16 GEMM over all 64 slots and 5-6 torch ops an arrival,
// ~44x the work of the slots that post in the benchmark's live cell, and
// the session lock was held through it.  This kernel folds only the slots
// that posted, counting their hits from the library's packed words.
//
// What it computes, for slot g at base age b with k new rows (arrival
// i = b + t, ascending t), library entry e of n valid rows:
//     h(e, r, t)   = popc(Pl_er & Pq_t) + popc(Nl_er & Nq_t), words masked
//                    to the first `mask_pairs` pairs; rows r >= n hold no bit
//     d_a[g, e, d] += h(e, d + i, t) * inv_lib[e, d + i]      d + i < n
//     d_b[g, e, d] += h(e, i - d, t) * inv_q[t]               0 <= i - d < n
// with inv_q[t] = 1 / (popc(Pq_t) + popc(Nq_t)) (0 for a row with no bit),
// each product and sum rounded once in f32 (__fmul_rn, __fadd_rn: no FMA
// contraction), the terms in ascending t.  Terms of rows past n are +0 in
// the plain version and are skipped here.  One lane owns each output
// element (d mod 32): it reads the element once a pass, adds the pass's
// arrivals in order in a register and writes it once, so the bits equal
// the plain version's sequential in-place adds; no atomics.
//
// Bound on the H100: device memory.  The library's valid rows are read once
// a flush (65,536 entries x ~55 rows x 2 planes x 16 bytes ~ 117 MB at
// W = 4; rows past kRows read kT - 1 rows more a chunk), and each posting
// slot's touched state is read and written once (~75 MB a slot: d_a's
// [L, S] and d_b's [L, n + k - 1] window).  The __popc, one a compared word
// for each (row, arrival), are ~0.12 G a slot at k = 8, 0.03 ms at 16 a
// clock an SM: bytes bound a flush of a few slots, the __popc one of more
// than ~20.
//
// Design: every warp works alone, with no barrier wider than the warp.  A
// persistent grid's warps take library entries in turn, and each entry in
// chunks of up to kRows rows (one chunk where S <= kRows, as at the live
// cell's 80), so that a warp's shared memory does not grow with S.  Chunk c
// loads rows c * kRows on, kT - 1 more than it owns: an element whose
// lowest row of a pass is one the chunk owns finds every row of the pass's
// window there (d_a's element d takes rows d + i0 .. d + i0 + kT - 1 of the
// pass from arrival i0, d_b's rows i0 - d .. i0 - d + kT - 1, the rows below
// 0 owned by chunk 0), and that lowest row only grows from pass to pass, so
// each element still takes its terms in ascending arrival order.  A chunk's
// rows and inv_lib arrive by cp.async into the warp's double buffer (the
// next chunk loads while this one folds, the count of the entry after it a
// step further ahead), and are used by every posting slot of the flush.
// For each slot, kT arrivals a pass: the lanes stage the pass's query rows,
// masked, and their inv_q in the warp's shared memory; a lane a library row
// counts the row's hits against them into a [kT, span] tile of 16-bit
// counts; then a lane a state element adds the tile's terms (d_a's and
// d_b's elements loaded together, kUnroll a lane).  One pop count a word,
// popc((Pl & Pq) | (Nl & Nq)), where the library row sets no pair in both
// planes (no fingerprint row does, but the words may; such a row takes
// two).  A flush of one slot and one of 64 run the same code, and a warp's
// shared memory is at most ~21 KB (W = 8, a chunk of kRows + kT - 1 rows),
// so four warps a CTA fit at every S (lbad_slot_fold).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;      // warps a CTA
constexpr int kT = 8;          // arrivals a pass: the depth of the hit tile
constexpr int kUnroll = 4;     // state elements of each orientation a lane loads at once
constexpr int kRows = 128;     // library rows a chunk owns (a multiple of 4)

__host__ __device__ constexpr long long round4(long long n) { return (n + 3) / 4 * 4; }

// Rows a chunk owns, and rows it loads (the kT - 1 past them where an entry
// takes more than one chunk).
__host__ __device__ constexpr int chunk_rows(int s) { return s < kRows ? s : kRows; }
__host__ __device__ constexpr int span_rows(int s) { return s <= kRows ? s : kRows + kT - 1; }

// A warp's shared-memory plan for a span of s rows, in 4-byte words (every
// region a multiple of 16 bytes):
//   2 x { lp, ln [s * w]   a chunk's rows (valid rows only)
//         inv_l  [s] f32 }
//   qp, qn  [kT * w]       the pass's query rows, masked
//   inv_q   [kT] f32
//   hits    [kT * s] u16   the pass's hit counts, [arrival][row]
struct Layout {
  long long lp, ln, inv_l, buf_words, qp, qn, inv_q, hits, total;
};

__host__ __device__ Layout layout(int s, int w) {
  Layout l;
  l.lp = 0;                                          // offsets inside a buffer
  l.ln = l.lp + round4(static_cast<long long>(s) * w);
  l.inv_l = l.ln + round4(static_cast<long long>(s) * w);
  l.buf_words = l.inv_l + round4(s);
  l.qp = 2 * l.buf_words;
  l.qn = l.qp + round4(kT * w);
  l.inv_q = l.qn + round4(kT * w);
  l.hits = l.inv_q + round4(kT);
  l.total = l.hits + round4((static_cast<long long>(s) * kT + 1) / 2);
  return l;
}

__device__ __forceinline__ unsigned word_mask(int k, int mask_pairs) {
  const int lo = 32 * k;
  if (mask_pairs >= lo + 32) return 0xFFFFFFFFu;
  if (mask_pairs <= lo) return 0u;
  return (1u << (mask_pairs - lo)) - 1u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(d), "l"(src) : "memory");
}

// One row of W words from shared memory, 16 or 8 bytes a load where W
// allows (rows start at multiples of W words).
template <int W>
__device__ __forceinline__ void load_row(const unsigned* src, unsigned (&x)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int v = 0; v < W / 4; ++v) {
      const uint4 u = reinterpret_cast<const uint4*>(src)[v];
      x[4 * v] = u.x; x[4 * v + 1] = u.y; x[4 * v + 2] = u.z; x[4 * v + 3] = u.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int v = 0; v < W / 2; ++v) {
      const uint2 u = reinterpret_cast<const uint2*>(src)[v];
      x[2 * v] = u.x; x[2 * v + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int v = 0; v < W; ++v) x[v] = src[v];
  }
}

// The hit counts of one library row (words a, z) against the pass's nt
// query rows, into the tile column `col` (rows s apart).  Where the row sets
// no pair in both planes (kBoth false), (Pl & Pq) and (Nl & Nq) share no bit
// and one popc counts both.
template <int W, bool kBoth>
__device__ __forceinline__ void count_row(const unsigned (&a)[W], const unsigned (&z)[W],
                                          const unsigned* qp, const unsigned* qn, int nt,
                                          unsigned short* col, int s) {
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    if (t < nt) {
      unsigned p[W], q[W];
      load_row<W>(qp + t * W, p);
      load_row<W>(qn + t * W, q);
      int h = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if constexpr (kBoth) {
          h += __popc(a[w] & p[w]) + __popc(z[w] & q[w]);
        } else {
          h += __popc((a[w] & p[w]) | (z[w] & q[w]));
        }
      }
      col[t * s] = static_cast<unsigned short>(h);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(32 * kWarps)
slot_fold_kernel(float* __restrict__ d_a, float* __restrict__ d_b, int batch,
                 long long n_entries, int s, int n_cap,
                 const unsigned* __restrict__ lib_pos, const unsigned* __restrict__ lib_neg,
                 const int* __restrict__ n_lib, const float* __restrict__ inv_lib,
                 int mask_pairs, int n_slots, int k_max, const int* __restrict__ slot_of,
                 const int* __restrict__ base_of, const int* __restrict__ k_of,
                 const unsigned* __restrict__ q_pos, const unsigned* __restrict__ q_neg,
                 bool vec16) {
  extern __shared__ __align__(16) unsigned smem[];
  const int chunk = chunk_rows(s), span = span_rows(s);
  const Layout lay = layout(span, W);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* mine = smem + warp * lay.total;
  unsigned* qp = mine + lay.qp;
  unsigned* qn = mine + lay.qn;
  float* inv_q = reinterpret_cast<float*>(mine + lay.inv_q);
  unsigned short* hits = reinterpret_cast<unsigned short*>(mine + lay.hits);
  const long long stride = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);

  // A warp's work, in turn: entry e's chunk c, rows c * chunk on of its n.
  struct Item {
    long long e;
    int c, n;
  };
  auto first = [&](long long l) {
    return Item{l, 0, l < n_entries ? min(max(__ldg(n_lib + l), 0), s) : 0};
  };
  auto after = [&](const Item& it) {
    return (it.c + 1) * chunk < it.n ? Item{it.e, it.c + 1, it.n} : first(it.e + stride);
  };
  // Copies the chunk's rows (at most span) and their inv_lib into buffer
  // `buf`.  With vec16, s * W and chunk * W are multiples of 4 words, so the
  // last 16-byte copy stays inside the entry.
  auto copy_rows = [&](const Item& it, int buf) {
    unsigned* base = mine + buf * lay.buf_words;
    const int r0 = it.c * chunk, m = min(it.n - r0, span);
    const size_t row0 = static_cast<size_t>(it.e) * s + r0;
    const size_t src = row0 * W;
    const int words = m * W;
    if (vec16) {
      for (int u = 4 * lane; u < words; u += 128) {
        cp_async16(base + lay.lp + u, lib_pos + src + u);
        cp_async16(base + lay.ln + u, lib_neg + src + u);
      }
    } else {
      for (int u = lane; u < words; u += 32) {
        cp_async4(base + lay.lp + u, lib_pos + src + u);
        cp_async4(base + lay.ln + u, lib_neg + src + u);
      }
    }
    for (int r = lane; r < m; r += 32) cp_async4(base + lay.inv_l + r, inv_lib + row0 + r);
  };

  Item cur = first(static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp);
  Item nxt = after(cur);
  if (cur.n > 0) copy_rows(cur, 0);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int k = 0; cur.e < n_entries; ++k) {
    const Item later = after(nxt);
    // This chunk's rows landed; every lane left the other buffer at the
    // previous chunk.
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncwarp();
    if (nxt.n > 0) copy_rows(nxt, (k + 1) & 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    const unsigned* buf = mine + (k & 1) * lay.buf_words;
    const unsigned* lp = buf + lay.lp;
    const unsigned* ln = buf + lay.ln;
    const float* inv_l = reinterpret_cast<const float*>(buf + lay.inv_l);
    const long long e = cur.e;
    const int n = cur.n, r0 = cur.c * chunk, m = min(n - r0, span);

    for (int g = 0; n > 0 && g < n_slots; ++g) {
      const int slot = __ldg(slot_of + g), b = __ldg(base_of + g);
      const int kg = min(__ldg(k_of + g), k_max);
      if (kg <= 0 || slot < 0 || slot >= batch || b < 0) continue;   // the same for all lanes
      float* sa = d_a + (static_cast<size_t>(slot) * n_entries + e) * s;
      float* sb = d_b + (static_cast<size_t>(slot) * n_entries + e) * n_cap;
      for (int t0 = 0; t0 < kg; t0 += kT) {
        const int nt = min(kT, kg - t0);
        const int i0 = b + t0;                       // the pass's first arrival
        // The pass's query rows, masked, then their inv_q: a lane a row.
        for (int x = lane; x < nt * W; x += 32) {
          const int w = x % W;
          const size_t at = (static_cast<size_t>(g) * k_max + t0) * W + x;
          qp[x] = __ldg(q_pos + at) & word_mask(w, mask_pairs);
          qn[x] = __ldg(q_neg + at) & word_mask(w, mask_pairs);
        }
        __syncwarp();
        if (lane < nt) {
          int n_bits = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) n_bits += __popc(qp[lane * W + w]) + __popc(qn[lane * W + w]);
          inv_q[lane] = n_bits > 0 ? __fdiv_rn(1.0f, static_cast<float>(n_bits)) : 0.0f;
        }
        // Hit counts of the pass: a lane a loaded row, its words held in
        // registers against each arrival's query row.
        for (int r = lane; r < m; r += 32) {
          unsigned a[W], z[W], both = 0;
          load_row<W>(lp + r * W, a);
          load_row<W>(ln + r * W, z);
#pragma unroll
          for (int w = 0; w < W; ++w) both |= a[w] & z[w];
          if (both) {
            count_row<W, true>(a, z, qp, qn, nt, hits + r, span);
          } else {
            count_row<W, false>(a, z, qp, qn, nt, hits + r, span);
          }
        }
        __syncwarp();
        // The elements whose lowest row of the pass the chunk owns (rows r0
        // to r0 + chunk - 1; chunk 0 also the rows below 0).  Orientation A:
        // d_a[d] takes row d + i of arrival i while d + i < n, for d from
        // r0 - i0 to min(r0 + chunk, n) - i0 - 1.  Orientation B: d_b[d]
        // takes row i - d of arrival i while 0 <= i - d < n, for d from
        // max(0, i0 - n + 1) to i0 + nt - 1 with i0 - d in the chunk's rows.
        // Each walked from the multiple of 32 below, so that lane d mod 32
        // owns d in every pass and chunk.
        const int a_lo = max(r0 - i0, 0), a_hi = min(r0 + chunk, n) - i0;
        const int a_at = a_lo & ~31, na = a_hi - a_at;
        const int b_end = min(i0 + nt, n_cap);
        const int b_lo = max(max(0, i0 - n + 1), i0 - r0 - chunk + 1);
        const int b_hi = r0 == 0 ? b_end : min(i0 - r0 + 1, b_end);
        const int b_at = b_lo & ~31, nb = b_hi - b_at;
        for (int j0 = 0; j0 < max(na, nb); j0 += 32 * kUnroll) {
          float va[kUnroll], vb[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int j = j0 + u * 32 + lane;
            if (j < na && a_at + j >= a_lo) va[u] = sa[a_at + j];
            if (j < nb && b_at + j >= b_lo) vb[u] = sb[b_at + j];
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int j = j0 + u * 32 + lane;
            int d = a_at + j;
            if (j < na && d >= a_lo) {
              float acc = va[u];
              const int terms = min(nt, n - i0 - d);
#pragma unroll
              for (int t = 0; t < kT; ++t) {
                if (t < terms) {
                  const int r = d + i0 + t - r0;
                  acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(hits[t * span + r]),
                                                 inv_l[r]));
                }
              }
              sa[d] = acc;
            }
            d = b_at + j;
            if (j < nb && d >= b_lo) {
              float acc = vb[u];
              const int t_lo = max(0, d - i0), t_hi = min(nt, n + d - i0);
#pragma unroll
              for (int t = 0; t < kT; ++t) {
                if (t >= t_lo && t < t_hi) {
                  acc = __fadd_rn(acc, __fmul_rn(
                      static_cast<float>(hits[t * span + (i0 + t - d - r0)]), inv_q[t]));
                }
              }
              sb[d] = acc;
            }
          }
        }
        __syncwarp();                                // the tile and the queries are free
      }
    }
    cur = nxt;
    nxt = later;
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <int W>
int launch(float* d_a, float* d_b, int batch, long long n_entries, int s, int n_cap,
           const unsigned* lib_pos, const unsigned* lib_neg, const int* n_lib,
           const float* inv_lib, int mask_pairs, int n_slots, int k_max, const int* slot_of,
           const int* base_of, const int* k_of, const unsigned* q_pos, const unsigned* q_neg,
           bool vec16, cudaStream_t stream) {
  auto kernel = slot_fold_kernel<W>;
  const int smem = static_cast<int>(kWarps * layout(span_rows(s), W).total * 4);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kWarps, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = min((n_entries + kWarps - 1) / kWarps,
                             static_cast<long long>(max(per_sm, 1)) * sms);
  kernel<<<static_cast<unsigned>(grid), 32 * kWarps, smem, stream>>>(
      d_a, d_b, batch, n_entries, s, n_cap, lib_pos, lib_neg, n_lib, inv_lib, mask_pairs,
      n_slots, k_max, slot_of, base_of, k_of, q_pos, q_neg, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Folds the new rows of `n_slots` posting slots into d_a [batch, n_entries,
// s] and d_b [batch, n_entries, n_cap] (f32, in place): slot_of, base_of and
// k_of [n_slots] give each one's state row (distinct), base age and rows,
// q_pos and q_neg [n_slots, k_max, w] its query words.
extern "C" int lbad_slot_fold(float* d_a, float* d_b, int batch, long long n_entries, int s,
                              int n_cap, const int* lib_pos, const int* lib_neg,
                              const int* n_lib, const float* inv_lib, int mask_pairs,
                              int n_slots, int k_max, const int* slot_of, const int* base_of,
                              const int* k_of, const int* q_pos, const int* q_neg, int w,
                              void* stream) {
  if (batch < 0 || n_entries < 0 || s < 1 || n_cap < 0 || mask_pairs < 0 || n_slots < 0
      || k_max < 0 || w < 1 || w > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_slots == 0 || k_max == 0 || n_entries == 0) return static_cast<int>(cudaGetLastError());
  const bool vec16 = (static_cast<long long>(s) * w) % 4 == 0
                     && (reinterpret_cast<uintptr_t>(lib_pos) & 15u) == 0
                     && (reinterpret_cast<uintptr_t>(lib_neg) & 15u) == 0;
  using Launch = int (*)(float*, float*, int, long long, int, int, const unsigned*,
                         const unsigned*, const int*, const float*, int, int, int, const int*,
                         const int*, const int*, const unsigned*, const unsigned*, bool,
                         cudaStream_t);
  static constexpr Launch kLaunch[8] = {launch<1>, launch<2>, launch<3>, launch<4>,
                                        launch<5>, launch<6>, launch<7>, launch<8>};
  return kLaunch[w - 1](d_a, d_b, batch, n_entries, s, n_cap,
                        reinterpret_cast<const unsigned*>(lib_pos),
                        reinterpret_cast<const unsigned*>(lib_neg), n_lib, inv_lib, mask_pairs,
                        n_slots, k_max, slot_of, base_of, k_of,
                        reinterpret_cast<const unsigned*>(q_pos),
                        reinterpret_cast<const unsigned*>(q_neg), vec16,
                        static_cast<cudaStream_t>(stream));
}
