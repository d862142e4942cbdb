// Band rows, or per-frame 2-D Haar coefficients, for windows at starts that
// the host computed: any hop (fractional or integer), any frame geometry.
//
//   audio [B, T] f32, starts [n_rows] i32
//     ->  rows   [B, n_rows, bands] f32                        (rows mode)
//     or  coeffs [B, n_rows, bands] f32: H_rpf . F . H_bands^T for every
//         frame F of rows_per_frame consecutive rows           (coefficients)
//
// Replaces three TPU kernels of lbaudiodetective_tpu/ops/pallas/:
//  - fused_rows.py :: fused_band_rows (_rows_kernel): band rows at
//    fractional window starts, no Haar;
//  - fused_rows_v2.py :: _rows_kernel_v2: rows, or with fuse_haar the
//    coefficients, at an integer hop;
//  - fused_rows_v2.py :: _rows_kernel_v3 with fuse_haar at the frame
//    geometries that csrc/fused_rows.cu does not take (rows_per_frame != 128,
//    pitch_step_count != 32).
// It computes what fused_rows.py::_rows_kernel computes: window sample
// n = 128 a + b; stage-1 DFT over a (16 taps, c16/s16); per residue r the
// stage-2 twiddles over b (the vDSP 2x folded in); quirk Q5 (positive parts
// x 1/divisor); |X|^2 with non-finite values set to 0; the band projection
// (row r * k_max + slot of proj_perm, 1/width folded in).
//
// Bound on the H100: operations.  Per 128 windows at k_max 43, stage 2 is a
// complex [128 x 128 b] @ [128 b x 43 slots] product per residue, 45.1 M
// FMA, run as 3xTF32 tensor-core products (495 TFLOP/s); stage 1 (8.4 M
// FMA), the projection (2.8 M) and in coefficients mode the Haar products
// stay FP32 (67 TFLOP/s).  At [256, 7168 rows] that is 7.8 ms if the two
// pipes overlap and 12.9 ms if not.  Device memory moves one audio span in
// and 16 KB of rows out per 128 windows.
//
// Design (the stage-2 tile, the warp layout and the level removal of
// csrc/fused_rows.cu, through dft_stage2.cuh):
//  - Window starts come from a device table (FingerprintConfig.row_starts:
//    a float64 floor on the host) and are never recomputed on the device, so
//    fractional and integer hops share one code path and no start drifts.
//  - One CTA of 512 threads (16 warps) per (tile, clip).  A tile is one
//    frame of rows_per_frame rows (coefficients) or `sub` rows (rows mode).
//    Its windows run in sub-tiles of `sub` <= 128 windows; each sub-tile's
//    audio span (start of its last window - start of its first + 2048
//    samples, zero past T) is staged in shared memory.  The host picks the
//    largest `sub` whose span fits, so large hops and large frames split
//    instead of failing.
//  - The sub-tile's windows form slabs of 16, each owned by a pair of warps.
//    Per residue, per pass of 48 slots of k_max and per 32-wide chunk of b,
//    each warp builds the stage-1 values G of 8 of its slab's windows (16
//    taps, FP32 FMA) in the swizzled layout of stage2_g_index, then runs
//    stage 2 of the slab's 16 windows for its 24 slots on the tensor cores
//    in 3xTF32 (dft_stage2.cuh::stage2_chunk<true>), the sums in registers.
//    At a pass's end the pair writes Q5 and |X|^2 over the G it has read,
//    and each warp adds its 8 windows' band projection to the rows, a lane
//    a band, each weight (staged in shared memory) read once for all of its
//    windows.  Slots past k_max have zero twiddles and weights.
//  - In a full sub-tile warp g holds windows g, g + 16, ..., g + 112.  At a
//    hop near 8 (the parity hop, and the fractional hop of the reference's
//    oracle mode) they start 128 samples apart, or one sample less, so one
//    warp's 128 stage-1 taps read 23 (or 46) samples a lane instead of 128
//    (stage1_slide).  Other hops read 16 samples a window.
//  - Each k-step of 8 b is summed in a fresh accumulator and then added to
//    the running sum in float32: the tensor cores add with truncation, and
//    on the running sum that left the result 4x further from the float64
//    evaluation than the float32 plain version, enough to move sign bits
//    at 150 pairs (subfingerprint_length 300) against the NumPy oracle.
//  - The chunk's twiddle fragments (ops/constants.py::stage2_fragments) and
//    a pass's projection weights arrive by cp.async, one chunk ahead into
//    two buffers; one block barrier a chunk makes them visible and frees the
//    other buffer.
//  - Level removal, exact because residue 0's stage-2 twiddles sum to zero
//    over b: the sub-tile's first sample (0 if it is not finite) is taken
//    from every sample of its span, and one constant a window (the mean of
//    its first 32 residue-0 values) from its residue-0 stage-1 values.  The
//    TF32 split and the tensor cores (which add with truncation) then work on
//    the small remainder, not brown noise's level.  A NaN or inf sample
//    still makes only the windows that hold it non-finite (and zero).
//  - Each (window, band) sum is owned by one lane of one warp and kept in
//    shared memory; every mma and add runs in a fixed order: two runs give
//    identical bits (no floating-point atomics).
//  - Coefficients: the frame's rows stay in shared memory; the column pass
//    (x H_bands^T) goes through the G and fragment regions in chunks of
//    rows, and the row pass (H_rpf x) reads H_rpf through the read-only
//    cache and writes the output.
#include <cuda_runtime.h>

#include <cstdint>

#include "dft_stage2.cuh"

namespace {

// 0 in the library the port loads.  scripts/torch_band_rows_ablation.py
// builds copies with bits set, each switching one step off to time what it
// costs (their results are wrong): 1 stage 1, 2 the stage-2 mma, 4 the band
// projection, 8 the fragment copies; 16 sums stage 2 straight into the
// running sums, as csrc/fused_rows.cu does (faster, and ~4x further from
// the float64 evaluation).
#ifndef LBAD_BAND_ROWS_SKIP
#define LBAD_BAND_ROWS_SKIP 0
#endif
constexpr int kSkip = LBAD_BAND_ROWS_SKIP;

constexpr int kThreads = 512;
constexpr int kWindow = 2048;
constexpr int kA = 16;            // stage-1 length (n = a * 128 + b)
constexpr int kB = 128;           // stage-2 length
constexpr int kTile = 128;        // most windows in one sub-tile
constexpr int kChunk = lbad::kS2Chunk;
constexpr int kChunksPerPass = kB / kChunk;
constexpr int kSlots = lbad::kS2Slots;             // slots of one pass
constexpr int kSlab = lbad::kS2WarpRows;           // windows a warp pair owns
constexpr int kGroup = 8;         // windows a warp builds and projects
constexpr int kVStride = 52;      // row stride of V (float4 reads)
constexpr int kCoefFloats = 2 * kA * kA;
static_assert(kThreads / 32 == 2 * kTile / kSlab, "a warp pair per 16-window slab");
static_assert(2 * lbad::kS2WarpSlotTiles == lbad::kS2SlotTiles, "a pair covers 48 slots");
static_assert(2 * kGroup == kSlab, "a warp builds half of its slab");
static_assert(lbad::kS2WarpGFloats >= kSlab * kVStride, "a slab's V over its G");

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Stage 1 of 8 windows that start 128 samples apart, or one sample less
// for a window w whose bit w of `shift` is set (kShift): window w's tap a
// is sample 128 (w + a) (less one) after the first window's start, so 23
// loads (46) a lane serve the 8 windows' 128 taps.  Each sum runs over a
// ascending, as one window's would.
template <bool kShift>
__device__ __forceinline__ void stage1_slide(const float* x, int shift, const float (&cr)[kA],
                                             const float (&ci)[kA], float (&gr)[kGroup],
                                             float (&gi)[kGroup]) {
#pragma unroll
  for (int k = 0; k < kGroup + kA - 1; ++k) {
    const float xa = x[k * kB];
    const float xb = kShift && k > 0 ? x[k * kB - 1] : xa;
#pragma unroll
    for (int w = 0; w < kGroup; ++w) {
      const int a = k - w;
      if (a >= 0 && a < kA) {
        const float xv = kShift && ((shift >> w) & 1) ? xb : xa;
        gr[w] = fmaf(xv, cr[a], gr[w]);
        gi[w] = fmaf(xv, ci[a], gi[w]);
      }
    }
  }
}

// Shared-memory plan, in floats (every region a multiple of 16 bytes):
//   span  [span_pad]                      audio of the sub-tile, less its
//                                         first sample
//   g     [n_slabs][kS2WarpGFloats]       G_re/G_im of a chunk; a slab's
//                                         block is reused as its V [16][52]
//   tw    [2][kS2TwFloats]                fragments of two chunks; with g the
//                                         column pass's scratch at the end
//   rows  [max(frame, sub * bands)]       the sub-tile's band rows (rows
//                                         mode) or the frame (coefficients)
//   pw    [kSlots][bands]                 projection weights of one pass
//   coef  [2 * kA * kA]                   stage-1 matrices c16, s16 ([a][r])
//   dc    [kTile]                         each window's residue-0 offset
//   offs  [kTile] int                     window offsets in the span
struct Layout {
  int n_slabs, g, tw, rows, pw, coef, dc, offs, total;
};

__host__ __device__ Layout layout(int sub, int bands, int span_pad, int frame_floats) {
  Layout l;
  l.n_slabs = (sub + kSlab - 1) / kSlab;
  l.g = span_pad;
  l.tw = l.g + l.n_slabs * lbad::kS2WarpGFloats;
  l.rows = l.tw + 2 * lbad::kS2TwFloats;
  const int rows_floats = frame_floats > sub * bands ? frame_floats : sub * bands;
  l.pw = l.rows + round4(rows_floats);
  l.coef = l.pw + kSlots * bands;
  l.dc = l.coef + kCoefFloats;
  l.offs = l.dc + kTile;
  l.total = l.offs + kTile;
  return l;
}

__global__ void __launch_bounds__(kThreads, 1)
band_rows_kernel(const float* __restrict__ audio, long long t_len,
                 const int* __restrict__ starts, int n_rows, int tile_rows,
                 int sub, int bands, int k_max, int span_pad,
                 const float* __restrict__ c16, const float* __restrict__ s16,
                 const float* __restrict__ t2_frag, const float* __restrict__ proj,
                 const float* __restrict__ h_rows, const float* __restrict__ h_cols_t,
                 float inv_div, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const bool coeffs = h_rows != nullptr;
  const Layout lay = layout(sub, bands, span_pad, coeffs ? tile_rows * bands : 0);
  float* span = smem;
  float* tw = smem + lay.tw;
  float* rows = smem + lay.rows;
  float* pw = smem + lay.pw;
  float* coef = smem + lay.coef;
  float* dc = smem + lay.dc;
  int* offs = reinterpret_cast<int*>(smem + lay.offs);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int clip = blockIdx.y;
  const int tile_row0 = blockIdx.x * tile_rows;
  const float* clip_audio = audio + static_cast<long long>(clip) * t_len;
  float* clip_out = out + static_cast<size_t>(clip) * n_rows * bands;
  const int n_pass = (k_max + kSlots - 1) / kSlots;
  const int n_chunks = kA * n_pass * kChunksPerPass;

  // This warp's slab, its 8 windows (rows q0 .. q0 + 7 of the slab's 16)
  // and its slot tiles.  A full sub-tile of 128 windows gives warp g the
  // windows g, g + 16, ..., g + 112, which start ~128 samples apart at a hop
  // near 8, so stage 1 slides over them; a smaller one gives it windows
  // p0 .. p0 + 7, and a slab past its windows sits it out.
  const int slab = warp >> 1;
  const int q0 = (warp & 1) * kGroup;
  const int p0 = slab * kSlab + q0;
  const int tile0 = (warp & 1) * lbad::kS2WarpSlotTiles;
  const bool active = slab < lay.n_slabs;
  const bool strided = sub == kTile;
  const int win0 = strided ? warp : p0;             // window of row q0 + w: win0 + step w
  const int step = strided ? kThreads / 32 : 1;
  const int n_mine = strided ? kGroup : min(kGroup, sub - p0);   // windows that are rows
  int shift = -1;     // the sub-tile's sliding mask (stage1_slide), -1: no sliding
  float* g_re = smem + lay.g + slab * lbad::kS2WarpGFloats;
  float* g_im = g_re + kSlab * kChunk;

  for (int i = tid; i < kA * kA; i += kThreads) {
    coef[i] = __ldg(c16 + i);
    coef[kA * kA + i] = __ldg(s16 + i);
  }

  // Stage 1 of chunk c for this warp's 8 windows: G_r[p][b0 + lane] =
  // sum_a x_p[a*128 + b0 + lane] w_r[a], a ascending.
  auto stage1 = [&](int c) {
    const int r = c / (n_pass * kChunksPerPass);
    const int b0 = (c % kChunksPerPass) * kChunk;
    float cr[kA], ci[kA];                             // c16[a][r], s16[a][r]
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      cr[a] = coef[a * kA + r];
      ci[a] = coef[kA * kA + a * kA + r];
    }
    float gr[kGroup], gi[kGroup];
#pragma unroll
    for (int w = 0; w < kGroup; ++w) gr[w] = gi[w] = 0.0f;
    if (shift >= 0) {
      const float* x = span + offs[win0] + b0 + lane;
      if (shift == 0) {
        stage1_slide<false>(x, 0, cr, ci, gr, gi);
      } else {
        stage1_slide<true>(x, shift, cr, ci, gr, gi);
      }
    } else {
#pragma unroll
      for (int w = 0; w < kGroup; ++w) {
        const float* x = span + offs[win0 + step * w] + b0 + lane;
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          const float xv = x[a * kB];
          gr[w] = fmaf(xv, cr[a], gr[w]);
          gi[w] = fmaf(xv, ci[a], gi[w]);
        }
      }
    }
#pragma unroll
    for (int w = 0; w < kGroup; ++w) {
      if (r == 0) gr[w] -= lbad::residue0_offset(gr[w], b0, dc + win0 + step * w);
      g_re[lbad::stage2_g_index(q0 + w, lane)] = gr[w];
      g_im[lbad::stage2_g_index(q0 + w, lane)] = gi[w];
    }
  };

  lbad::Stage2Acc acc;
  // Stage 2 of chunk c on the tensor cores (the pair's G of chunk c is
  // complete and visible), and at a pass's end Q5, |X|^2 and this warp's
  // band projection into `acc_rows`.
  auto stage2 = [&](int c, float* acc_rows) {
    const int b0 = (c % kChunksPerPass) * kChunk;
    if (b0 == 0) lbad::stage2_zero(acc);
    if (!(kSkip & 2)) {
      lbad::stage2_chunk<!(kSkip & 16)>(g_re, tw + (c & 1) * lbad::kS2TwFloats, tile0, acc);
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
    // rows[p][k] += sum_slot V[p][slot] P[slot][k] for this warp's windows,
    // slots of the pass ascending, four at a time (V and P are 0 past k_max).
    const int pass = (c / kChunksPerPass) % n_pass;
    const int n4 = (kSkip & 4) ? 0 : (min(kSlots, k_max - pass * kSlots) + 3) / 4;
    if (32 % bands == 0) {
      // Lane (i0, k) = (lane / bands, lane % bands) owns band k of windows
      // i0, i0 + per, ...: a weight is read once for all of them.
      const int per = 32 / bands, k = lane % bands, i0 = lane / bands;
      float sum[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int i = i0 + j * per;
        sum[j] = i < n_mine ? acc_rows[(win0 + step * i) * bands + k] : 0.0f;
      }
      for (int s4 = 0; s4 < n4; ++s4) {
        const float* w = pw + 4 * s4 * bands + k;
        const float w0 = w[0], w1 = w[bands], w2 = w[2 * bands], w3 = w[3 * bands];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const int i = i0 + j * per;
          if (i < kGroup) {
            const float4 x = reinterpret_cast<const float4*>(v + (q0 + i) * kVStride)[s4];
            sum[j] = fmaf(x.x, w0, sum[j]);
            sum[j] = fmaf(x.y, w1, sum[j]);
            sum[j] = fmaf(x.z, w2, sum[j]);
            sum[j] = fmaf(x.w, w3, sum[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int i = i0 + j * per;
        if (i < n_mine) acc_rows[(win0 + step * i) * bands + k] = sum[j];
      }
      return;
    }
    for (int e = lane; e < n_mine * bands; e += 32) {
      const int i = e / bands;
      const int k = e - i * bands;
      const float4* vrow = reinterpret_cast<const float4*>(v + (q0 + i) * kVStride);
      float* dst = acc_rows + (win0 + step * i) * bands + k;
      float s = *dst;
      for (int s4 = 0; s4 < n4; ++s4) {
        const float4 x = vrow[s4];
        const float* w = pw + 4 * s4 * bands + k;
        s = fmaf(x.x, w[0], s);
        s = fmaf(x.y, w[bands], s);
        s = fmaf(x.z, w[2 * bands], s);
        s = fmaf(x.w, w[3 * bands], s);
      }
      *dst = s;
    }
  };

  for (int st = 0; st < tile_rows; st += sub) {
    const int row0 = tile_row0 + st;
    if (row0 >= n_rows) break;                   // ragged last rows tile
    const int n_valid = min(sub, n_rows - row0);
    const int base = __ldg(starts + row0);
    const int span_len = __ldg(starts + row0 + n_valid - 1) - base + kWindow;
    float* acc_rows = rows + (coeffs ? st * bands : 0);

    __syncthreads();                             // previous sub-tile's readers done
    // The first chunk's fragments start to arrive while the span loads.
    lbad::stage2_prefetch(t2_frag, tw);
    for (int p = tid; p < kTile; p += kThreads) {
      offs[p] = p < n_valid ? __ldg(starts + row0 + p) - base : 0;
    }
    // Less one constant, the sub-tile's first sample (0 if not finite), from
    // every sample, the zero padding too: only residue 0 sees it, and its
    // twiddles cancel it.
    const float first = base < t_len ? clip_audio[base] : 0.0f;
    const float level = isfinite(first) ? first : 0.0f;
    for (int i = tid; i < span_pad; i += kThreads) {
      const long long t = static_cast<long long>(base) + i;
      span[i] = (i < span_len && t < t_len ? clip_audio[t] : 0.0f) - level;
    }
    for (int i = tid; i < sub * bands; i += kThreads) acc_rows[i] = 0.0f;

#pragma unroll 1
    for (int k = 0; k < n_chunks; ++k) {
      // Chunk k's fragments (and at a pass's last chunk its projection
      // weights) were issued one chunk ahead; after the barrier they are
      // visible, and every warp is past chunk k - 1, so its fragment buffer,
      // the weights of the pass before and the pairs' G are free.
      lbad::stage2_wait_prefetch();
      __syncthreads();
      const int next = k + 1;
      if (next < n_chunks && next % kChunksPerPass == kChunksPerPass - 1) {
        lbad::cp_async_floats(pw, proj + static_cast<size_t>(next / kChunksPerPass)
                                             * kSlots * bands, kSlots * bands);
      }
      lbad::stage2_prefetch(
          next < n_chunks && !(kSkip & 8)
              ? t2_frag + static_cast<size_t>(next) * lbad::kS2TwFloats : nullptr,
          tw + (next & 1) * lbad::kS2TwFloats);
      if (k == 0 && strided) {
        // Slide when windows win0 + 16 w start 128 w samples after win0, or
        // one sample earlier (a fractional hop near 8 drifts by < 1).
        int mask = 0;
        bool slides = true;
        for (int w = 1; w < kGroup; ++w) {
          const int d = offs[win0 + step * w] - offs[win0] - kB * w;
          mask |= (d == -1) << w;
          slides = slides && (d == 0 || d == -1);
        }
        shift = slides ? mask : -1;
      }
      if (active) {
        if (!(kSkip & 1)) stage1(k);
        lbad::pair_sync(slab);
        stage2(k, acc_rows);
      }
    }

    if (!coeffs) {
      __syncthreads();                           // every warp's projection done
      float* dst = clip_out + static_cast<size_t>(row0) * bands;
      for (int e = tid; e < n_valid * bands; e += kThreads) dst[e] = acc_rows[e];
    }
  }
  if (!coeffs) return;

  // ---- 2-D Haar of the frame: C = H_rpf . (F . H_bands^T) -----------------
  __syncthreads();
  float* frame = rows;
  float* scratch = smem + lay.g;                 // g and tw, contiguous
  const int scratch_floats = lay.rows - lay.g;
  const int chunk_rows = min(tile_rows, scratch_floats / bands);
  for (int c0 = 0; c0 < tile_rows; c0 += chunk_rows) {
    const int n = min(chunk_rows, tile_rows - c0) * bands;
    for (int e = tid; e < n; e += kThreads) {
      const int p = c0 + e / bands;
      const int k = e % bands;
      const float* f = frame + p * bands;
      float s = 0.0f;
      for (int c = 0; c < bands; ++c) s = fmaf(f[c], __ldg(h_cols_t + c * bands + k), s);
      scratch[e] = s;
    }
    __syncthreads();
    for (int e = tid; e < n; e += kThreads) frame[c0 * bands + e] = scratch[e];
    __syncthreads();
  }
  for (int e = tid; e < tile_rows * bands; e += kThreads) {
    const int q = e / bands;
    const int k = e % bands;
    const float* h = h_rows + static_cast<size_t>(q) * tile_rows;
    float s = 0.0f;
    for (int p = 0; p < tile_rows; ++p) s = fmaf(__ldg(h + p), frame[p * bands + k], s);
    clip_out[static_cast<size_t>(tile_row0) * bands + e] = s;
  }
}

}  // namespace

// Bytes of dynamic shared memory the kernel needs for sub-tiles of `sub`
// windows of `bands` bands whose audio spans take span_pad floats (a
// multiple of 4); frame_floats is rows_per_frame * bands in coefficients
// mode and 0 in rows mode.  -1 when the kernel takes no such sub-tile.
extern "C" long long lbad_band_rows_smem_bytes(int sub, int bands, int span_pad,
                                               int frame_floats) {
  if (sub < 1 || sub > kTile || bands < 1 || span_pad < kWindow || span_pad % 4 != 0
      || frame_floats < 0) {
    return -1;
  }
  return static_cast<long long>(layout(sub, bands, span_pad, frame_floats).total) * 4;
}

// Bytes of shared memory a block may opt in to on the current device, or the
// CUDA error code negated.
extern "C" long long lbad_band_rows_smem_limit() {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  return err == cudaSuccess ? limit : -static_cast<long long>(err);
}

// h_rows and h_cols_t both non-null select coefficients mode, in which
// tile_rows is rows_per_frame; in rows mode tile_rows == sub.
// t2_frag: the stage-2 twiddle fragments [16 residues][passes][4 chunks]
// [kS2TwFloats] and proj the band projection [16][passes][48][bands], slots
// past k_max zero (ops/constants.py::stage2_fragments, projection_passes),
// both 16-byte aligned; passes = ceil(k_max / 48).
extern "C" int lbad_band_rows(const float* audio, int batch, long long t_len,
                              const int* starts, int n_rows, int tile_rows,
                              int sub, int bands, int k_max, int span_pad,
                              const float* c16, const float* s16,
                              const float* t2_frag, const float* proj,
                              const float* h_rows, const float* h_cols_t,
                              float inv_div, float* out, void* stream) {
  const bool coeffs = h_rows != nullptr;
  const long long smem = lbad_band_rows_smem_bytes(sub, bands, span_pad,
                                                   coeffs ? tile_rows * bands : 0);
  if ((h_rows == nullptr) != (h_cols_t == nullptr) || smem < 0 || k_max < 1
      || tile_rows < sub || tile_rows % sub != 0
      || (!coeffs && tile_rows != sub) || (coeffs && n_rows % tile_rows != 0)
      || (reinterpret_cast<uintptr_t>(t2_frag) & 15u) != 0
      || (reinterpret_cast<uintptr_t>(proj) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const long long limit = lbad_band_rows_smem_limit();
  if (limit < 0) return static_cast<int>(-limit);
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(band_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n_rows + tile_rows - 1) / tile_rows, batch);
  band_rows_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      audio, t_len, starts, n_rows, tile_rows, sub, bands, k_max, span_pad, c16,
      s16, t2_frag, proj, h_rows, h_cols_t, inv_div, out);
  return static_cast<int>(cudaGetLastError());
}
