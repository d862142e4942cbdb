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
// Bound on the H100: integer issue.  A 1M-entry library of 80-row entries
// is 2.7 GB of words (~0.8 ms at HBM rate), but each entry costs
// n_offsets x n_short x 2W AND+popc+add, a few G __popc per full scan.
//
// Design: one warp per (query, entry), so nothing carries between blocks
// (the TPU kernel unpacks to bf16 for its MXU and shears with lane rolls;
// on Hopper the words stay packed and the arithmetic is exact integers).
// A CTA stages its query's masked words and inv_q in shared memory; each
// warp stages its entry's masked words and inv_lib.  Rows are stored with
// an odd stride (2*Wu + 1 words), so lanes reading different rows hit
// different banks.  Lanes own the valid offsets and sum their diagonal in
// order in f32 (explicit _rn operations: no FMA contraction, IEEE
// division), then the warp takes the max with __shfl_xor_sync.  Every
// entry's score depends on that entry and the query alone, so a score is
// bit-identical whatever library it is computed in.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned word_mask(int k, int mask_pairs) {
  const int lo = 32 * k;
  if (mask_pairs >= lo + 32) return 0xFFFFFFFFu;
  if (mask_pairs <= lo) return 0u;
  return (1u << (mask_pairs - lo)) - 1u;
}

// Stage `n` rows of `w` words (pos and neg planes) as masked rows of
// stride `rs` = [pos words 0..wu) [neg words 0..wu), and each row's
// reciprocal possible-hit count.  Called by `count` threads from `t`.
__device__ __forceinline__ void stage_rows(const unsigned* __restrict__ pos,
                                           const unsigned* __restrict__ neg,
                                           int n, int w, int wu, int rs,
                                           int mask_pairs, unsigned* rows,
                                           int t, int count) {
  for (int idx = t; idx < n * wu; idx += count) {
    const int j = idx / wu, k = idx - j * wu;
    const unsigned m = word_mask(k, mask_pairs);
    rows[j * rs + k] = pos[static_cast<size_t>(j) * w + k] & m;
    rows[j * rs + wu + k] = neg[static_cast<size_t>(j) * w + k] & m;
  }
}

__device__ __forceinline__ float inv_possible(const unsigned* row, int wu) {
  int c = 0;
  for (int k = 0; k < wu; ++k) c += __popc(row[k] | row[wu + k]);
  return c > 0 ? __fdiv_rn(1.0f, static_cast<float>(c)) : 0.0f;
}

__device__ __forceinline__ float row_hits(const unsigned* a, const unsigned* b, int n_words) {
  int h = 0;
  for (int k = 0; k < n_words; ++k) h += __popc(a[k] & b[k]);
  return static_cast<float>(h);
}

__global__ void match_packed_kernel(const unsigned* __restrict__ q_pos,
                                    const unsigned* __restrict__ q_neg,
                                    const int* __restrict__ n_q, int sq,
                                    const unsigned* __restrict__ lib_pos,
                                    const unsigned* __restrict__ lib_neg,
                                    const int* __restrict__ n_lib,
                                    long long n_entries, int sl, int w, int wu,
                                    int mask_pairs, float* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const int rs = 2 * wu + 1;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned* qw = smem;                                          // [sq, rs]
  float* inv_q = reinterpret_cast<float*>(qw + sq * rs);        // [sq]
  unsigned* lw = reinterpret_cast<unsigned*>(inv_q + sq) + warp * sl * (rs + 1);
  float* inv_l = reinterpret_cast<float*>(lw + sl * rs);        // [sl]

  const int b = blockIdx.y;
  const int nq = min(max(n_q[b], 0), sq);
  const size_t q_off = static_cast<size_t>(b) * sq * w;
  stage_rows(q_pos + q_off, q_neg + q_off, nq, w, wu, rs, mask_pairs, qw,
             threadIdx.x, blockDim.x);
  __syncthreads();
  for (int i = threadIdx.x; i < nq; i += blockDim.x) inv_q[i] = inv_possible(qw + i * rs, wu);
  __syncthreads();

  const long long l = static_cast<long long>(blockIdx.x) * warps + warp;
  if (l >= n_entries) return;                 // whole warps only: no barrier follows
  const int nl = min(max(n_lib[l], 0), sl);
  const size_t l_off = static_cast<size_t>(l) * sl * w;
  stage_rows(lib_pos + l_off, lib_neg + l_off, nl, w, wu, rs, mask_pairs, lw, lane, 32);
  __syncwarp();
  for (int j = lane; j < nl; j += 32) inv_l[j] = inv_possible(lw + j * rs, wu);
  __syncwarp();

  float best = 0.0f;
  if (nq > 0 && nl > 0) {
    if (nl < nq) {                            // B: the query slides
      for (int o = lane; o <= nq - nl; o += 32) {
        float acc = 0.0f;
        for (int i = 0; i < nl; ++i) {
          const float h = row_hits(lw + i * rs, qw + (o + i) * rs, 2 * wu);
          acc = __fadd_rn(acc, __fmul_rn(h, inv_q[o + i]));
        }
        best = fmaxf(best, __fdiv_rn(acc, static_cast<float>(nl)));
      }
    } else {                                  // A: the entry slides
      for (int o = lane; o <= nl - nq; o += 32) {
        float acc = 0.0f;
        for (int i = 0; i < nq; ++i) {
          const float h = row_hits(lw + (o + i) * rs, qw + i * rs, 2 * wu);
          acc = __fadd_rn(acc, __fmul_rn(h, inv_l[o + i]));
        }
        best = fmaxf(best, __fdiv_rn(acc, static_cast<float>(nq)));
      }
    }
  }
  for (int s = 16; s > 0; s >>= 1) best = fmaxf(best, __shfl_xor_sync(0xFFFFFFFFu, best, s));
  if (lane == 0) out[static_cast<size_t>(b) * n_entries + l] = best;
}

}  // namespace

// Shared memory one CTA of `warps` warps needs, in bytes.
extern "C" long long lbad_match_packed_smem_bytes(int sq, int sl, int w, int mask_pairs,
                                                  int warps) {
  const int wu = min(w, (mask_pairs + 31) / 32);
  const long long rs = 2 * wu + 1;
  return 4 * (static_cast<long long>(sq) * (rs + 1) +
              static_cast<long long>(warps) * sl * (rs + 1));
}

extern "C" int lbad_match_packed(const int* q_pos, const int* q_neg, const int* n_q,
                                 int batch, int sq, const int* lib_pos,
                                 const int* lib_neg, const int* n_lib,
                                 long long n_entries, int sl, int w, int mask_pairs,
                                 int warps, float* out, void* stream) {
  const int wu = min(w, (mask_pairs + 31) / 32);
  const long long smem = lbad_match_packed_smem_bytes(sq, sl, w, mask_pairs, warps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((n_entries + warps - 1) / warps),
                  static_cast<unsigned>(batch));
  match_packed_kernel<<<grid, warps * 32, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const unsigned*>(q_pos), reinterpret_cast<const unsigned*>(q_neg),
      n_q, sq, reinterpret_cast<const unsigned*>(lib_pos),
      reinterpret_cast<const unsigned*>(lib_neg), n_lib, n_entries, sl, w, wu,
      mask_pairs, out);
  return static_cast<int>(cudaGetLastError());
}
