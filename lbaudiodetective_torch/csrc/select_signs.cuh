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
// so that a plain descending sort of the keys is exactly that order, and
// the key alone decodes to the class: 1 positive, 2 negative, 0 for zero
// (+0.0 and -0.0 both have abs bits 0) or NaN.  The sort compares the
// INTEGER abs bits: NaN's abs bits lie above the inf pattern, so NaNs rank
// first and decode to 0, and +/-inf keep their sign class -- as the
// reference's stable sort on ~(bits & 0x7FFFFFFF) does.  A float compare
// would misplace NaN.
#pragma once

#include <cstdint>

namespace lbad {

constexpr int kFrame = 4096;   // 128 rows x 32 bands, row-major
constexpr int kTop = 128;      // classes emitted per frame (callers keep k <= 128)

__device__ __forceinline__ unsigned long long select_key(float x, int idx) {
  const uint32_t bits = __float_as_uint(x);
  const uint32_t abs_bits = bits & 0x7FFFFFFFu;
  const uint32_t pos = ((bits >> 31) == 0u && abs_bits > 0u) ? 1u : 0u;
  const uint32_t lo = (static_cast<uint32_t>(kFrame - 1 - idx) << 1) | pos;
  return (static_cast<unsigned long long>(abs_bits) << 32) | lo;
}

// Sorts keys[0, 4096) descending with every thread of the block (full
// bitonic network, 78 stages, one barrier each), then writes the classes of
// the first 128 keys to out[0, 128).  The caller has written all keys and
// passed a __syncthreads() before the call.
__device__ __forceinline__ void select_top128(unsigned long long* keys, int* out) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int k = 2; k <= kFrame; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < kFrame / 2; p += nt) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));   // partner i + j
        const unsigned long long a = keys[i];
        const unsigned long long b = keys[i + j];
        // Blocks with (i & k) == 0 sort descending; at k == 4096 that is
        // every block, so the whole frame ends descending.
        const bool desc = (i & k) == 0;
        if (desc ? (a < b) : (a > b)) {
          keys[i] = b;
          keys[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int q = tid; q < kTop; q += nt) {
    const unsigned long long key = keys[q];
    const uint32_t abs_bits = static_cast<uint32_t>(key >> 32);
    const bool valid = abs_bits > 0u && abs_bits <= 0x7F800000u;   // not 0, not NaN
    out[q] = valid ? ((key & 1ull) ? 1 : 2) : 0;
  }
}

}  // namespace lbad
