// Fused band rows + 2-D Haar (+ top-128 sign select) for an integer hop
// that divides 128, window 2048, 128-row x 32-band frames.
//
//   audio [B, T] f32  ->  coefficients [B, n_tiles * 128, 32] f32
//                     or  classes      [B, n_tiles, 128]      i32
//
// Replaces the TPU kernel lbaudiodetective_tpu/ops/pallas/fused_rows_v2.py
// :: _rows_kernel_v3 (with fuse_haar and pipe_select).
// It computes what that kernel computes: windows at the integer hop ->
// two-stage DFT over bins [lo, hi) with the vDSP 2x scale -> quirk Q5
// (positive parts x 1/512) -> |X|^2 -> band projection (1/width) ->
// H128 . F . H32^T -> in classes mode the rank-ordered select.
//
// Bound on the H100 at the main path's [256, 7168 rows] (14,336 tiles of
// 128 windows, k_max 43): stage 2 is 45.1 M complex-tile FMA a tile, done as
// 3xTF32 tensor-core products: 3.88 TFLOP a batch, 7.8 ms at 495 TFLOP/s.
// The rest stays float32 FMA (stage 1 8.39 M, projection 2.82 M, Haar 0.66 M
// FMA a tile): 0.34 TFLOP, 5.1 ms at 67 TFLOP/s.  The bound is 7.8 ms if the
// two pipes overlap and 12.9 ms if not.  Device-memory traffic is small: one
// audio span (12-73 KB) in, 16 KB or 512 B out per tile, and 1.5 MB of
// stage-2 fragments that stay in L2.
//
// Design:
//  - One CTA of 512 threads (16 warps) per (tile of 128 windows, clip);
//    blocks share nothing.  The TPU kernel's tiles-per-step choice, its
//    lagged pipe_select scratch carry across grid steps, its tail kernel and
//    its select_outside fallback have no counterpart: each CTA selects its
//    own frame.
//  - The audio span of the tile (hop * 127 + 2048 samples) is loaded once
//    into shared memory; every window reads it from there.
//  - The 128 windows form 8 slabs of 16, each owned by a pair of warps.
//    Per residue r and per 32-wide chunk of b, each warp builds the stage-1
//    values G_r[window, b] of 8 of its slab's windows (16 taps each, float32
//    FMA) into the slab's block of shared memory, then runs stage 2 of the
//    slab's 16 windows for its half of the 48 slots on the tensor cores in
//    3xTF32 (dft_stage2.cuh), the accumulators in registers.  At a
//    residue's end the pair writes Q5 and |X|^2 of its slab over the G it
//    has read, and each warp adds 8 windows' band projection (weights staged
//    in shared memory) to the band rows.  Named barriers of the pair order
//    its steps.
//  - The chunk's twiddle fragments arrive by cp.async, issued one chunk
//    ahead into two buffers, and one block barrier a chunk makes them
//    visible and frees the other buffer; between barriers the pairs run
//    apart, so one pair's stage 1 (FP32 pipe) overlaps another's mma (tensor
//    pipe).
//  - Residue 0's stage-1 values G_0[p, b] = sum_a x_p[a*128 + b] carry 16
//    times each window's local mean, which residue 0's stage-2 twiddles
//    cancel exactly: sum_b T_0[b, k] = 0 for every k = 16 m, 0 < m < 128.
//    So the tile's first sample (0 if it is not finite) is subtracted from
//    every sample of its span (only residue 0 sees a constant), and one
//    constant a window (the mean of its first 32 values of G_0) from all its
//    128 values before stage 2.
//    X is unchanged in exact arithmetic, and the float32 stage 1, the TF32
//    split and the tensor cores (which add with truncation) work on the
//    small remainder instead of the signal's level (brown noise's largest
//    component).  The result is closer to the float64 evaluation of the
//    plain version than that version's own float32 evaluation is.
//  - Stage 1 reads each sample once for 8 windows: windows (v, w) and
//    (v, w + 1) start 128 samples apart, so the 16 taps of 8 consecutive w
//    cover 23 samples, held in registers (hops that are multiples of 8;
//    smaller hops read 16 samples a window).
//  - Each thread owns fixed (window, band) sums of the projection, kept in
//    shared memory between residues, and every mma runs in a fixed order, so
//    two runs give identical bits (no floating-point atomics).
//  - Windows are processed in the reference kernel's order p = v*wper + w
//    (window j = vper*w + v); the constant `perm` (H128 times the
//    un-permutation, from _v2_constants) maps them back while it applies the
//    row Haar pass, as on the TPU.  H32^T applies the column pass.
//  - In classes mode the coefficients never leave shared memory: the
//    frame's keys go through the same select routine as select_signs.cu
//    (row-major flat index row*32 + band).
//  - Shared memory at hop 8: 116.5 KiB (span 12 KiB, G 32 KiB, two fragment
//    buffers 48 KiB, the band rows 16 KiB, the projection weights of a
//    residue 6 KiB, the stage-1 matrices and offsets 2.5 KiB; the select's
//    scratch over the fragment buffers at the end), at hop 128 176 KiB: one
//    CTA an SM, 16 warps of at most 128 registers.
#include <cuda_runtime.h>

#include "dft_stage2.cuh"
#include "select_signs.cuh"

namespace {

// 0 in the library the port loads.  scripts/torch_fused_rows_ablation.py
// builds copies with bits set, each switching one step off to time what it
// costs (their results are wrong): 1 stage 1, 2 the stage-2 mma, 4 the band
// projection, 8 the fragment copies, 16 the select.
#ifndef LBAD_FUSED_ROWS_SKIP
#define LBAD_FUSED_ROWS_SKIP 0
#endif
constexpr int kSkip = LBAD_FUSED_ROWS_SKIP;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 2048;
constexpr int kA = 16;          // stage-1 length (n = a * 128 + b)
constexpr int kB = 128;         // stage-2 length
constexpr int kRows = 128;      // windows per tile == rows per frame
constexpr int kBands = 32;
constexpr int kChunk = lbad::kS2Chunk;
constexpr int kChunksPerResidue = kB / kChunk;
constexpr int kChunks = kA * kChunksPerResidue;   // 64 stage-2 chunks a tile
constexpr int kHalf = 64;       // proj_r slot stride
constexpr int kVStride = 52;    // row stride of V (fewer bank conflicts on store)
constexpr int kSlab = lbad::kS2WarpRows;          // windows a warp pair owns
constexpr int kGroup = 8;       // windows a warp builds: one stage-1 slide
static_assert(kWarps == 2 * kRows / kSlab, "a warp pair per 16-window slab");
static_assert(2 * lbad::kS2WarpSlotTiles == lbad::kS2SlotTiles, "a pair covers 48 slots");
static_assert(2 * kGroup == kSlab, "a warp builds half of its slab");

// Shared-memory plan, in floats:
//   span  [span_pad]                 audio of the tile, less its first sample
//   g     [8 slabs][kS2WarpGFloats]  G_re/G_im of a chunk; a slab's block is
//                                    reused as its V [16][kVStride]; at the
//                                    end T1 [kRows][kBands], then the keys
//   tw    [2][kS2TwFloats]           twiddle fragments of two chunks; at the
//                                    end the select's scratch
//   rows  [kRows][kBands]            band rows in window order p
//   pw    [kS2Slots][kBands]         projection weights of one residue
//   coef  [2 * kA * kA]              stage-1 matrices c16, s16 ([a][r])
//   dc    [kRows]                    each window's residue-0 offset
constexpr int kGFloats = (kRows / kSlab) * lbad::kS2WarpGFloats;
constexpr int kTwBufs = 2;
constexpr int kTwFloats = kTwBufs * lbad::kS2TwFloats;
constexpr int kRowsFloats = kRows * kBands;
constexpr int kPwFloats = lbad::kS2Slots * kBands;
constexpr int kCoefFloats = 2 * kA * kA + kRows;
constexpr int kExtraFloats = kTwFloats + kRowsFloats + kPwFloats + kCoefFloats;
static_assert(kGFloats >= 2 * lbad::kFrame && kGFloats >= kRows * kBands, "g region");
static_assert(lbad::kS2WarpGFloats >= kSlab * kVStride, "a slab's V");
static_assert(kTwFloats >= 2 * lbad::kSelectScratchWords, "select scratch region");
static_assert(kVStride % 4 == 0, "V rows read as float4");

__global__ void __launch_bounds__(kThreads, 1)
fused_rows_kernel(const float* __restrict__ audio, long long t_len, int n_tiles,
                  int hop, int span_pad,
                  const float* __restrict__ c16, const float* __restrict__ s16,
                  const float* __restrict__ t2_frag, const float* __restrict__ proj_r,
                  int k_max, const float* __restrict__ perm,
                  const float* __restrict__ h_cols_t, float inv_div,
                  float* __restrict__ coeffs_out, int* __restrict__ cls_out) {
  extern __shared__ __align__(16) float smem[];
  float* span = smem;
  float* g = span + span_pad;
  float* tw = g + kGFloats;
  float* rows = tw + kTwFloats;
  float* pw = rows + kRowsFloats;
  float* coef = pw + kPwFloats;
  float* dc = coef + 2 * kA * kA;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int clip = blockIdx.y;
  const int vper = kB / hop;               // windows per 128 samples
  const int wper = kRows / vper;
  // This warp's slab, the 8 windows it builds (q0 .. q0 + 7 of the slab),
  // its slot tiles, and its 8 rows of the projection (the same windows).
  const int slab = warp >> 1;
  const int q0 = (warp & 1) * kGroup;
  const int p0 = slab * kSlab + q0;
  const int tile0 = (warp & 1) * lbad::kS2WarpSlotTiles;
  float* g_re = g + slab * lbad::kS2WarpGFloats;
  float* g_im = g_re + kSlab * kChunk;
  float* my_rows = rows + p0 * kBands;     // rows[p0 + i][lane] at i * 32 + lane

  // The first chunk's fragments start to arrive while the span loads.
  lbad::stage2_prefetch(t2_frag, tw);

  // ---- audio span of this tile -------------------------------------------
  const long long base = static_cast<long long>(tile) * kRows * hop;
  const float* clip_audio = audio + static_cast<long long>(clip) * t_len;
  const int span_len = hop * (kRows - 1) + kWindow;
  // Less one constant, the tile's first sample, from every sample (the
  // zero padding too): residue 0 alone sees it, and its stage-2 twiddles
  // cancel it, as they cancel the per-window offset below.  A non-finite
  // first sample gives 0, so only the windows that hold it turn non-finite
  // (and zero), as in the plain version.
  const float first = base < t_len ? clip_audio[base] : 0.0f;
  const float level = isfinite(first) ? first : 0.0f;
  for (int i = tid; i < span_pad; i += kThreads) {
    const long long t = base + i;
    span[i] = (i < span_len && t < t_len ? clip_audio[t] : 0.0f) - level;
  }
  for (int i = tid; i < kA * kA; i += kThreads) {
    coef[i] = __ldg(c16 + i);
    coef[kA * kA + i] = __ldg(s16 + i);
  }
  for (int i = tid; i < kRowsFloats; i += kThreads) rows[i] = 0.0f;

  // Stage 1 of chunk c for this warp's 8 windows: G_r[p][b0 + lane] =
  // sum_a x_p[a*128 + b0 + lane] w_r[a], a ascending.
  auto stage1 = [&](int c) {
    const int r = c / kChunksPerResidue;
    const int b0 = (c % kChunksPerResidue) * kChunk;
    const float* cr = coef + r;                       // cr[a * kA] = c16[a][r]
    const float* ci = coef + kA * kA + r;
    if (wper % kGroup == 0) {
      // Windows p0 .. p0 + 7 share v; window p0 + w starts at
      // v * hop + (w0 + w) * 128, so tap a of window w is sample w + a.
      const float* x = span + (p0 / wper) * hop + (p0 % wper) * kB + b0 + lane;
      float xs[kGroup + kA - 1];
#pragma unroll
      for (int k = 0; k < kGroup + kA - 1; ++k) xs[k] = x[k * kB];
      float gr[kGroup], gi[kGroup];
#pragma unroll
      for (int w = 0; w < kGroup; ++w) gr[w] = gi[w] = 0.0f;
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        const float cw = cr[a * kA], sw = ci[a * kA];
#pragma unroll
        for (int w = 0; w < kGroup; ++w) {
          gr[w] = fmaf(xs[w + a], cw, gr[w]);
          gi[w] = fmaf(xs[w + a], sw, gi[w]);
        }
      }
#pragma unroll
      for (int w = 0; w < kGroup; ++w) {
        if (r == 0) gr[w] -= lbad::residue0_offset(gr[w], b0, dc + p0 + w);
        g_re[lbad::stage2_g_index(q0 + w, lane)] = gr[w];
        g_im[lbad::stage2_g_index(q0 + w, lane)] = gi[w];
      }
    } else {
#pragma unroll 1
      for (int w = 0; w < kGroup; ++w) {
        const int p = p0 + w;
        const int j = (p % wper) * vper + p / wper;   // natural window index
        const float* x = span + j * hop + b0 + lane;
        float gr = 0.0f, gi = 0.0f;
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          const float xv = x[a * kB];
          gr = fmaf(xv, cr[a * kA], gr);
          gi = fmaf(xv, ci[a * kA], gi);
        }
        if (r == 0) gr -= lbad::residue0_offset(gr, b0, dc + p);
        g_re[lbad::stage2_g_index(q0 + w, lane)] = gr;
        g_im[lbad::stage2_g_index(q0 + w, lane)] = gi;
      }
    }
  };

  lbad::Stage2Acc acc;
  // Stage 2 of chunk c on the tensor cores (the pair's G of chunk c is
  // complete and visible), and at a residue's end Q5, |X|^2 and this warp's
  // band projection.
  auto stage2 = [&](int c) {
    const int r = c / kChunksPerResidue;
    const int b0 = (c % kChunksPerResidue) * kChunk;
    if (b0 == 0) lbad::stage2_zero(acc);
    if (!(kSkip & 2)) {
      // The direct order: products go straight into the running sums.  It
      // is ~4x further from float64 than stage2_chunk<true>'s fresh sum a
      // k-step (band_rows.cu), which costs band rows ~3.5 ms at [256, 7168
      // rows]; at 128 x 32 it stays within the bar and the oracle's 99.9 %.
      lbad::stage2_chunk(g_re, tw + (c % kTwBufs) * lbad::kS2TwFloats, tile0, acc);
    }
    if (b0 + kChunk < kB) return;
    // Q5, |X|^2 and non-finite -> 0, into the slab's V [16][kVStride], over
    // the G both warps of the pair have just read.
    lbad::pair_sync(slab);
    float* v = g_re;
#pragma unroll
    for (int t = 0; t < lbad::kS2WarpSlotTiles; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float xr = acc.re[t][i];
        float xi = acc.im[t][i];
        xr = xr > 0.0f ? xr * inv_div : xr;
        xi = xi > 0.0f ? xi * inv_div : xi;
        float e = xr * xr + xi * xi;
        e = isfinite(e) ? e : 0.0f;
        v[lbad::stage2_row(i) * kVStride + lbad::stage2_slot(tile0, t, i)] = e;
      }
    }
    lbad::pair_sync(slab);
    // Band projection of residue r for this warp's 8 windows:
    // rows[p][k] += sum_slot V[p][slot] P_r[slot][k], slots ascending, four
    // at a time (V's slots from k_max on are 0, as are P_r's).
    float sum[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) sum[i] = my_rows[i * kBands + lane];
    const int n4 = (kSkip & 4) ? 0 : (k_max + 3) / 4;
    for (int s4 = 0; s4 < n4; ++s4) {
      const float* w = pw + 4 * s4 * kBands + lane;
      const float w0 = w[0], w1 = w[kBands], w2 = w[2 * kBands], w3 = w[3 * kBands];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const float4 e = reinterpret_cast<const float4*>(v + (q0 + i) * kVStride)[s4];
        sum[i] = fmaf(e.x, w0, sum[i]);
        sum[i] = fmaf(e.y, w1, sum[i]);
        sum[i] = fmaf(e.z, w2, sum[i]);
        sum[i] = fmaf(e.w, w3, sum[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) my_rows[i * kBands + lane] = sum[i];
  };

#pragma unroll 1
  for (int k = 0; k < kChunks; ++k) {
    // Chunk k's fragments (and at a residue's last chunk its projection
    // weights) were issued one chunk ahead; after the barrier they are
    // visible, and every warp is past chunk k - 1, so its fragment buffer and
    // the pairs' G are free.
    lbad::stage2_wait_prefetch();
    __syncthreads();
    const int next = k + 1;
    if (next < kChunks && next % kChunksPerResidue == kChunksPerResidue - 1) {
      lbad::cp_async_floats(pw, proj_r + static_cast<size_t>(next / kChunksPerResidue)
                                             * kHalf * kBands, kPwFloats);
    }
    lbad::stage2_prefetch(
        next < kChunks && !(kSkip & 8)
            ? t2_frag + static_cast<size_t>(next) * lbad::kS2TwFloats : nullptr,
        tw + (next % kTwBufs) * lbad::kS2TwFloats);
    if (!(kSkip & 1)) stage1(k);
    lbad::pair_sync(slab);
    stage2(k);
  }

  __syncthreads();                                   // rows written; tw, g readers done
  // ---- 2-D Haar: C = perm . rows . H32^T ----------------------------------
  // Column k = lane, rows p = warp + 16 i.
  constexpr int kPer = kRows / kWarps;
  float* t1 = g;                                     // [kRows][kBands]
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = warp + kWarps * i;
    float acc1 = 0.0f;
    for (int c = 0; c < kBands; ++c) {
      acc1 = fmaf(rows[p * kBands + c], __ldg(h_cols_t + c * kBands + lane), acc1);
    }
    t1[p * kBands + lane] = acc1;
  }
  __syncthreads();
  float coeff[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int q = warp + kWarps * i;
    const float* prow = perm + q * kRows;
    float acc1 = 0.0f;
    for (int p = 0; p < kRows; ++p) {
      acc1 = fmaf(__ldg(prow + p), t1[p * kBands + lane], acc1);
    }
    coeff[i] = acc1;
  }

  const size_t frame = static_cast<size_t>(clip) * n_tiles + tile;
  if (coeffs_out != nullptr) {
    float* out = coeffs_out + frame * kRows * kBands;
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[(warp + kWarps * i) * kBands + lane] = coeff[i];
    return;
  }
  __syncthreads();                                   // t1 readers done
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(g);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = (warp + kWarps * i) * kBands + lane;   // row-major flat index
    keys[idx] = lbad::select_key(coeff[i], idx);
  }
  __syncthreads();
  if (kSkip & 16) return;
  lbad::select_top128<kThreads>(keys, cls_out + frame * lbad::kTop,
                                reinterpret_cast<unsigned long long*>(tw));
}

}  // namespace

extern "C" int lbad_fused_rows_smem_bytes(int hop) {
  const int span_len = hop * (kRows - 1) + kWindow;
  const int span_pad = (span_len + 3) / 4 * 4;
  return static_cast<int>((span_pad + kGFloats + kExtraFloats) * sizeof(float));
}

// coeffs_out or cls_out (exactly one non-null) selects the output mode.
// t2_frag: the stage-2 twiddle fragments, [16 residues][4 chunks]
// [kS2TwFloats] (ops/constants.py::stage2_fragments), 16-byte aligned.
extern "C" int lbad_fused_rows(const float* audio, int batch, long long t_len,
                               int n_tiles, int hop, const float* c16,
                               const float* s16, const float* t2_frag,
                               const float* proj_r, int k_max, const float* perm,
                               const float* h_cols_t, float inv_div,
                               float* coeffs_out, int* cls_out, void* stream) {
  if (hop <= 0 || kB % hop != 0 || k_max <= 0 || k_max > lbad::kS2Slots
      || (reinterpret_cast<uintptr_t>(t2_frag) & 15u) != 0
      || (coeffs_out == nullptr) == (cls_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const int smem = lbad_fused_rows_smem_bytes(hop);
  const int span_pad = smem / static_cast<int>(sizeof(float)) - kGFloats - kExtraFloats;
  cudaError_t err = cudaFuncSetAttribute(
      fused_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_tiles, batch);
  fused_rows_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      audio, t_len, n_tiles, hop, span_pad, c16, s16, t2_frag, proj_r, k_max, perm,
      h_cols_t, inv_div, coeffs_out, cls_out);
  return static_cast<int>(cudaGetLastError());
}
