// Rank-ordered top-128 sign selection of one 4096-coefficient frame, as a
// device routine shared by the standalone select kernel (select_signs.cu)
// and the fused rows kernel (fused_rows.cu).
//
// Order: |x| descending, ties toward the lower flat index (the reference's
// index-stable NSNumber sort, LBAudioDetectiveFrame.m:165-191).  Each
// element becomes one 64-bit key
//
//     (abs_bits << 32) | ((4095 - idx) << 1) | pos
//
// so that a plain descending order of the keys is exactly that order, and
// the key alone decodes to the class: 1 positive, 2 negative, 0 for zero
// (+0.0 and -0.0 both have abs bits 0) or NaN.  Every comparison is on the
// INTEGER abs bits: NaN's abs bits lie above the inf pattern, so NaNs rank
// first and decode to 0, and +/-inf keep their sign class -- as the
// reference's stable sort on ~(bits & 0x7FFFFFFF) does.  A float compare
// would misplace NaN.
//
// Design (O(N) work instead of a full sort of 4096 keys):
//  1. Threshold.  A most-significant-digit radix select over the 31 low
//     bits of abs_bits (bit 31 is always 0) finds the abs bits T of the
//     128th-ranked key: digits of 8, 8, 8 and 7 bits (the first is the
//     float exponent), at most four passes, fewer when the bucket that
//     holds rank 128 is taken whole.  Each pass builds a 256-bin histogram
//     in shared memory with atomics spread over four lane-group copies (a
//     frame's exponents cluster in a few bins), then a block scan picks the
//     digit that holds rank 128.
//  2. Compaction.  Every key above the threshold, then the keys equal to it
//     in ascending flat index until 128 are taken, go to a 128-slot array.
//     Positions come from warp ballots and a block prefix sum, not
//     atomics, so the result is deterministic.
//  3. Order.  Each of the 128 keys counts the keys above it (they are
//     unique), which is its rank; its class is written there.
#pragma once

#include <cstdint>

namespace lbad {

constexpr int kFrame = 4096;   // 128 rows x 32 bands, row-major
constexpr int kTop = 128;      // classes emitted per frame (callers keep k <= 128)
constexpr int kHistCopies = 4;                        // lane & 3 picks the copy
constexpr int kHistStride = 257;                      // copies in different banks
constexpr int kSelectMaxWarps = 16;                   // blocks of 256 or 512 threads
// Shared scratch of select_top128, in 8-byte words: the 128 selected keys,
// then the histograms, the warp sums and the picked digit.
constexpr int kSelectScratchWords =
    kTop + (kHistCopies * kHistStride + kSelectMaxWarps + 3 + 1) / 2;

__device__ __forceinline__ unsigned long long select_key(float x, int idx) {
  const uint32_t bits = __float_as_uint(x);
  const uint32_t abs_bits = bits & 0x7FFFFFFFu;
  const uint32_t pos = ((bits >> 31) == 0u && abs_bits > 0u) ? 1u : 0u;
  const uint32_t lo = (static_cast<uint32_t>(kFrame - 1 - idx) << 1) | pos;
  return (static_cast<unsigned long long>(abs_bits) << 32) | lo;
}

// Flat index of a thread's j-th key (of 4096 / NT): warp w owns a
// contiguous range, and within it the lanes read consecutive keys, so
// ballots over j go in ascending index order.
template <int NT>
__device__ __forceinline__ int select_owned_index(int j) {
  return (threadIdx.x >> 5) * (32 * (kFrame / NT)) + j * 32 + (threadIdx.x & 31);
}

// Inclusive sum over a block of NT threads of one int a thread.  Two
// barriers.
template <int NT>
__device__ __forceinline__ int select_block_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) before += w < warp ? warp_sums[w] : 0;
  __syncthreads();   // warp_sums may be reused
  return v + before;
}

// Writes the classes of the 128 highest keys of keys[0, 4096) to
// out[0, 128).  Runs with all NT (256 or 512) threads of the block; the
// caller has written every key and passed a __syncthreads() before the call.
// scratch: kSelectScratchWords of shared memory, apart from the keys.
template <int NT>
__device__ __forceinline__ void select_top128(const unsigned long long* keys, int* out,
                                              unsigned long long* scratch) {
  static_assert(NT == 256 || NT == 512, "a block of 256 or 512 threads");
  constexpr int kKeysPerThread = kFrame / NT;
  constexpr int kPerKey = NT / kTop;       // threads that rank one key
  unsigned long long* sel = scratch;                         // [kTop]
  int* hist = reinterpret_cast<int*>(scratch + kTop);        // [copies][kHistStride]
  int* warp_sums = hist + kHistCopies * kHistStride;         // [NT / 32]
  int* pick = warp_sums + kSelectMaxWarps;  // digit, keys still wanted, bucket size

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int* my_hist = hist + (lane & (kHistCopies - 1)) * kHistStride;

  uint32_t a[kKeysPerThread];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    a[j] = static_cast<uint32_t>(keys[select_owned_index<NT>(j)] >> 32);
  }

  // ---- 1. radix select of the threshold -----------------------------------
  uint32_t prefix = 0;     // abs >> shift of the bucket holding rank 128
  int shift = 31;          // every abs_bits >> 31 is 0 == prefix
  int want = kTop;         // keys still wanted from that bucket
#pragma unroll 1
  for (int pass = 0; pass < 4; ++pass) {
    const int next = pass < 3 ? 23 - 8 * pass : 0;
    const uint32_t digit_mask = (1u << (shift - next)) - 1u;
    for (int i = tid; i < kHistCopies * kHistStride; i += NT) hist[i] = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      if ((a[j] >> shift) == prefix) atomicAdd(my_hist + ((a[j] >> next) & digit_mask), 1);
    }
    __syncthreads();
    // Bins in descending digit order: bin d at scan position 255 - d.
    int count = 0;
    if (tid < 256) {
      const int d = 255 - tid;
#pragma unroll
      for (int c = 0; c < kHistCopies; ++c) count += hist[c * kHistStride + d];
    }
    const int incl = select_block_scan<NT>(count, warp_sums);
    const int above = incl - count;       // keys of the bucket with a larger digit
    if (tid < 256 && above < want && incl >= want) {
      pick[0] = 255 - tid;
      pick[1] = want - above;
      pick[2] = count;
    }
    __syncthreads();
    prefix = (prefix << (shift - next)) | static_cast<uint32_t>(pick[0]);
    shift = next;
    want = pick[1];
    if (pick[2] == want) break;           // the whole bucket is taken
  }

  // ---- 2. compaction: all above the threshold, then ties by index ---------
  // Keys above go to sel[0, 128 - want), ties to sel[128 - want, 128).
  int n_above = 0, n_tie = 0;
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const uint32_t v = a[j] >> shift;
    n_above += __popc(__ballot_sync(0xFFFFFFFFu, v > prefix));
    n_tie += __popc(__ballot_sync(0xFFFFFFFFu, v == prefix));
  }
  // One value a warp, packed: ties in the high half (<= 4096), above in the
  // low half (<= 127).
  const int packed =
      select_block_scan<NT>(lane == 0 ? (n_tie << 16) | n_above : 0, warp_sums);
  // Lane 0 holds the warp's inclusive sum; subtract the warp's own counts.
  const int warp_incl = __shfl_sync(0xFFFFFFFFu, packed, 0);
  int above_at = (warp_incl & 0xFFFF) - n_above;
  int tie_at = (warp_incl >> 16) - n_tie;
  const int above_total = kTop - want;
  const uint32_t lt_mask = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const uint32_t v = a[j] >> shift;
    const unsigned up = __ballot_sync(0xFFFFFFFFu, v > prefix);
    const unsigned eq = __ballot_sync(0xFFFFFFFFu, v == prefix);
    if (v > prefix) {
      sel[above_at + __popc(up & lt_mask)] = keys[select_owned_index<NT>(j)];
    } else if (v == prefix) {
      const int t = tie_at + __popc(eq & lt_mask);
      if (t < want) sel[above_total + t] = keys[select_owned_index<NT>(j)];
    }
    above_at += __popc(up);
    tie_at += __popc(eq);
  }
  __syncthreads();

  // ---- 3. rank by counting, decode ----------------------------------------
  // kPerKey neighbouring lanes a key, each comparing every kPerKey-th slot.
  const unsigned long long mine = sel[tid / kPerKey];
  int rank = 0;
#pragma unroll 8
  for (int i = tid % kPerKey; i < kTop; i += kPerKey) rank += sel[i] > mine ? 1 : 0;
#pragma unroll
  for (int off = 1; off < kPerKey; off <<= 1) rank += __shfl_xor_sync(0xFFFFFFFFu, rank, off);
  if (tid % kPerKey == 0) {
    const uint32_t abs_bits = static_cast<uint32_t>(mine >> 32);
    const bool valid = abs_bits > 0u && abs_bits <= 0x7F800000u;   // not 0, not NaN
    out[rank] = valid ? ((mine & 1ull) ? 1 : 2) : 0;
  }
}

}  // namespace lbad
