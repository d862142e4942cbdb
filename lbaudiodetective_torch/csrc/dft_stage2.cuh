// Stage 2 of the two-stage DFT of a 128-window tile on the tensor cores, in
// 3xTF32: a device-side building block of the rows kernels.
//
// Per residue r and per 32-wide chunk of b, the complex product
//
//   X[p, s] += sum_b G[p, b] * T[b, s]     (p: 128 windows, s: 48 slots)
//
// is four real products (X_re += G_re T_re - G_im T_im, X_im += G_re T_im +
// G_im T_re), the layout of the JAX package's t2a/t2b planes
// (fused_rows_v2.py:179).  Each runs on mma.sync.m16n8k8 in TF32 with the
// operands split into a high and a low TF32 part: hi = rna(x),
// lo = rna(x - hi), which holds x within 2^-22 relative, and a b = a_lo b_hi +
// a_hi b_lo + a_hi b_hi (the lo*lo term, ~2^-22 relative, is dropped) --
// at least as exact as the reference's 3-pass bf16 split on the TPU's
// matrix unit (fused_rows_v2.py:160-172).
//
// The tensor cores add each product into the float32 accumulator with
// truncation, so the error grows with the magnitudes summed: the caller
// keeps them small (fused_rows.cu takes the signal's level out of residue
// 0).  Per k-step the small terms go in first, then the a_hi b_hi terms; the
// order is fixed, so two runs give the same bits.
//
//  - Twiddles are split on the host and stored in mma fragment order
//    (ops/constants.py::stage2_fragments): for each (residue, chunk, k-step
//    of 8 b, tile of 8 slots) one float4 {hi_b0, hi_b1, lo_b0, lo_b1} a lane
//    for T_re, then one for T_im, so a lane reads its B fragments with two
//    conflict-free 128-bit shared loads.  -T_im is T_im with the sign bits
//    flipped (exact, since rna is symmetric).
//  - A warp owns 16 windows and half of the 48 slots: three 16 x 8
//    accumulator tiles each for X_re and X_im, 24 float32 registers a lane,
//    so its six accumulation chains and their operands fit in registers.
//    It reads G only for its 16 windows, from their block of shared memory
//    (G_re rows, then G_im rows), so G can be built and read by the two
//    warps of a window slab alone.
//  - G is split as its A fragments are loaded from shared memory
//    (cvt.rna.tf32.f32).  A row of G is 32 floats with its columns XOR-ed by
//    4 (row & 7) (stage2_g_index), so the 32 lanes of a fragment load, and
//    of a row written by the 32 lanes of stage 1, hit 32 different banks
//    without padding.
//  - stage2_prefetch copies the next chunk's fragments (24 KB) into shared
//    memory with cp.async, so they arrive while the current chunk's mma run.
#pragma once

#include <cstdint>

namespace lbad {

constexpr int kS2Chunk = 32;                          // b values a chunk
constexpr int kS2KSteps = kS2Chunk / 8;               // mma k-steps a chunk
constexpr int kS2SlotTiles = 6;                       // 48 slots = 6 x 8
constexpr int kS2Slots = 8 * kS2SlotTiles;
constexpr int kS2WarpSlotTiles = 3;                   // slot tiles a warp owns
constexpr int kS2WarpRows = 16;                      // windows a warp owns
constexpr int kS2WarpGFloats = 2 * kS2WarpRows * kS2Chunk;     // a warp's G_re, G_im

// Position of G[row][col] (col < 32) in a warp's G plane.
__device__ __forceinline__ int stage2_g_index(int row, int col) {
  return row * kS2Chunk + (col ^ ((row & 7) << 2));
}
constexpr int kS2TwFloats = kS2KSteps * kS2SlotTiles * 2 * 32 * 4;   // 6144 (24 KB)

struct Stage2Acc {
  float re[kS2WarpSlotTiles][4];
  float im[kS2WarpSlotTiles][4];
};

__device__ __forceinline__ void stage2_zero(Stage2Acc& acc) {
#pragma unroll
  for (int t = 0; t < kS2WarpSlotTiles; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc.re[t][i] = 0.0f;
      acc.im[t][i] = 0.0f;
    }
  }
}

// x rounded to TF32 (nearest, ties away from zero); the low 13 bits are 0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a_lo b_hi + a_hi b_lo, the small terms of a 3xTF32 product; b holds
// {hi_b0, hi_b1, lo_b0, lo_b1}, and `flip` (0 or the sign bit) negates it.
__device__ __forceinline__ void mma_small(float (&d)[4], const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4], const float4 b,
                                          uint32_t flip) {
  mma_tf32(d, a_lo, __float_as_uint(b.x) ^ flip, __float_as_uint(b.y) ^ flip);
  mma_tf32(d, a_hi, __float_as_uint(b.z) ^ flip, __float_as_uint(b.w) ^ flip);
}

// d += a_hi b_hi, the large term.
__device__ __forceinline__ void mma_big(float (&d)[4], const uint32_t (&a_hi)[4],
                                        const float4 b, uint32_t flip) {
  mma_tf32(d, a_hi, __float_as_uint(b.x) ^ flip, __float_as_uint(b.y) ^ flip);
}

// A fragment of rows (row0, row0 + 8) x cols (col, col + 4) of a G plane,
// split into TF32 hi and lo.
__device__ __forceinline__ void stage2_load_a(const float* g, int row0, int col,
                                              uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float v[4] = {g[stage2_g_index(row0, col)], g[stage2_g_index(row0 + 8, col)],
                      g[stage2_g_index(row0, col + 4)], g[stage2_g_index(row0 + 8, col + 4)]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(v[i]);
    lo[i] = tf32_rna(v[i] - __uint_as_float(hi[i]));
  }
}

// The four real products of one k-step into one slot tile's sums (re, im):
// X_re += G_re T_re - G_im T_im;  X_im += G_re T_im + G_im T_re, the small
// terms first, then the a_hi b_hi terms.
__device__ __forceinline__ void stage2_terms(float (&re)[4], float (&im)[4],
                                             const uint32_t (&re_hi)[4],
                                             const uint32_t (&re_lo)[4],
                                             const uint32_t (&im_hi)[4],
                                             const uint32_t (&im_lo)[4], const float4 t_re,
                                             const float4 t_im) {
  constexpr uint32_t kSign = 0x80000000u;
  mma_small(re, re_hi, re_lo, t_re, 0u);
  mma_small(re, im_hi, im_lo, t_im, kSign);
  mma_small(im, re_hi, re_lo, t_im, 0u);
  mma_small(im, im_hi, im_lo, t_re, 0u);
  mma_big(re, re_hi, t_re, 0u);
  mma_big(re, im_hi, t_im, kSign);
  mma_big(im, re_hi, t_im, 0u);
  mma_big(im, im_hi, t_re, 0u);
}

// One chunk of 32 b: acc += G[:, chunk] T[chunk, :] for the calling warp's
// 16 windows and slot tiles [tile0, tile0 + kS2WarpSlotTiles).  g: the
// windows' block, G_re [16][32] then G_im (stage2_g_index), in shared
// memory; tw: the chunk's fragments (kS2TwFloats) in shared memory.
// kFresh sums each slot tile's k-step of 8 b in a fresh accumulator and
// adds it to acc in float32 (round to nearest): the tensor cores'
// truncation then acts on an 8-term partial sum, not on the running sum,
// which leaves the result ~4x closer to the exact product for 24 more float
// adds a k-step (csrc/band_rows.cu).  Without it the terms go straight into
// acc (csrc/fused_rows.cu).
template <bool kFresh = false>
__device__ __forceinline__ void stage2_chunk(const float* g, const float* tw, int tile0,
                                             Stage2Acc& acc) {
  const float* g_re = g;
  const float* g_im = g + kS2WarpRows * kS2Chunk;
  const int lane = threadIdx.x & 31;
  const int row0 = lane >> 2;
  const int tig = lane & 3;
  const float4* frag = reinterpret_cast<const float4*>(tw);
#pragma unroll
  for (int ks = 0; ks < kS2KSteps; ++ks) {
    uint32_t re_hi[4], re_lo[4], im_hi[4], im_lo[4];
    stage2_load_a(g_re, row0, ks * 8 + tig, re_hi, re_lo);
    stage2_load_a(g_im, row0, ks * 8 + tig, im_hi, im_lo);
#pragma unroll
    for (int t = 0; t < kS2WarpSlotTiles; ++t) {
      const float4 t_re = frag[((ks * kS2SlotTiles + tile0 + t) * 2 + 0) * 32 + lane];
      const float4 t_im = frag[((ks * kS2SlotTiles + tile0 + t) * 2 + 1) * 32 + lane];
      if constexpr (kFresh) {
        float re[4] = {0.0f, 0.0f, 0.0f, 0.0f}, im[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        stage2_terms(re, im, re_hi, re_lo, im_hi, im_lo, t_re, t_im);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc.re[t][i] += re[i];
          acc.im[t][i] += im[i];
        }
      } else {
        stage2_terms(acc.re[t], acc.im[t], re_hi, re_lo, im_hi, im_lo, t_re, t_im);
      }
    }
  }
}

// Window (row of the warp's 16) and slot of accumulator element i of the
// warp's slot tile t.
__device__ __forceinline__ int stage2_row(int i) {
  return ((threadIdx.x & 31) >> 2) + (i >> 1) * 8;
}
__device__ __forceinline__ int stage2_slot(int tile0, int t, int i) {
  return (tile0 + t) * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

// Starts copying n floats (a multiple of 4, both ends 16-byte aligned) from
// global to shared memory with cp.async, spread over the block's threads.
__device__ __forceinline__ void cp_async_floats(float* dst, const float* src, int n) {
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(base + 16u * i), "l"(src + 4 * i) : "memory");
  }
}

// Starts the copy of one chunk's fragments into shared memory and commits it,
// with any copy started before, as one cp.async group; every thread of the
// block calls it.  nullptr commits the earlier copies alone.
__device__ __forceinline__ void stage2_prefetch(const float* src, float* dst) {
  if (src != nullptr) cp_async_floats(dst, src, kS2TwFloats);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until every cp.async group of this thread landed.
__device__ __forceinline__ void stage2_wait_prefetch() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The residue-0 offset of one window, from the warp that holds its stage-1
// values for b0 .. b0 + 31 (a lane each): at b0 == 0 the mean of those 32,
// taken by lane 0's order and stored to *dc; later chunks read *dc.  Every
// lane subtracts the same value, so the offset is constant over b.  Residue
// 0's stage-2 twiddles sum to zero over b, so X does not change; the
// products then work on the small remainder, not the window's level.
__device__ __forceinline__ float residue0_offset(float g, int b0, float* dc) {
  if (b0 != 0) return *dc;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) g += __shfl_xor_sync(0xFFFFFFFFu, g, off);
  const float mean = __shfl_sync(0xFFFFFFFFu, g, 0) * (1.0f / 32.0f);
  if ((threadIdx.x & 31) == 0) *dc = mean;
  return mean;
}

// Barrier of the two warps of window slab `slab` (named barriers 1-8).
__device__ __forceinline__ void pair_sync(int slab) {
  asm volatile("bar.sync %0, 64;" :: "r"(slab + 1) : "memory");
}

}  // namespace lbad
