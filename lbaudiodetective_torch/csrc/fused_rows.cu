// Fused band rows + 2-D Haar (+ top-128 sign select) for an integer hop
// that divides 128, window 2048, 128-row x 32-band frames.
//
//   audio [B, T] f32  ->  coefficients [B, n_tiles * 128, 32] f32
//                     or  classes      [B, n_tiles, 128]      i32
//
// Replaces the TPU kernel lbaudiodetective_tpu/ops/pallas/fused_rows_v2.py
// :: fused_band_rows_v3 (_rows_kernel_v3, with fuse_haar and pipe_select).
// It computes what that kernel computes: windows at the integer hop ->
// two-stage DFT over bins [lo, hi) with the vDSP 2x scale -> quirk Q5
// (positive parts x 1/512) -> |X|^2 -> band projection (1/width) ->
// H128 . F . H32^T -> in classes mode the rank-ordered select.
//
// Bound on the H100: float32 FMA throughput.  Stage 2 is a complex
// [128 windows x 128 b] @ [128 b x k_max slots] product per residue, about
// 45 M FMA per tile; stage 1, the projection and the Haar products add
// about a quarter of that.  Device-memory traffic is small: one audio span
// (12-73 KB) in, 16 KB or 512 B out per tile, and ~0.9 MB of constants that
// stay in L2.
//
// Design:
//  - One CTA per (tile of 128 windows, clip); blocks share nothing.  The
//    TPU kernel's tiles-per-step choice, its lagged pipe_select scratch
//    carry across grid steps, its tail kernel and its select_outside
//    fallback have no counterpart: each CTA selects its own frame.
//  - The audio span of the tile (hop * 127 + 2048 samples) is loaded once
//    into shared memory; every window reads it from there.
//  - Per residue r and per 32-wide chunk of b, the CTA builds the stage-1
//    values G_r[window, b] in shared memory from the span (16 taps each)
//    and stages that chunk's twiddles; each thread then accumulates a
//    4-window x 6-slot complex register tile of stage 2.  Plain FP32 FMA:
//    no TF32, no bf16, no split operands.
//  - Q5, |X|^2 and the band projection run per residue from shared memory;
//    each thread owns fixed (window, band) sums, so the order of every sum
//    is fixed and two runs give identical bits (no floating-point atomics).
//  - Windows are processed in the reference kernel's order p = v*wper + w
//    (window j = vper*w + v); the constant `perm` (H128 times the
//    un-permutation, from _v2_constants) maps them back while it applies the
//    row Haar pass, as on the TPU.  H32^T applies the column pass.
//  - In classes mode the coefficients never leave shared memory: the
//    frame's keys go through the same select routine as select_signs.cu
//    (row-major flat index row*32 + band).
#include <cuda_runtime.h>

#include "select_signs.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 2048;
constexpr int kA = 16;          // stage-1 length (n = a * 128 + b)
constexpr int kB = 128;         // stage-2 length
constexpr int kRows = 128;      // windows per tile == rows per frame
constexpr int kBands = 32;
constexpr int kChunk = 32;      // b values per stage-2 chunk
constexpr int kGStride = kChunk + 1;   // padded row of G (bank spread)
constexpr int kSlots = 48;      // k_max padded (k_max <= 48)
constexpr int kHalf = 64;       // t2a lane offset of the imaginary part
constexpr int kWinPerThread = 4;
constexpr int kSlotPerThread = 6;

// Shared-memory plan, in floats:
//   span  [span_pad]              audio of the tile
//   big   [2 * kRows * kGStride]  G_re/G_im of one chunk; reused as V
//                                 [kRows][kSlots], then as T1 [kRows][kBands]
//                                 and finally as the select keys (32 KB)
//   tw    [2 * kChunk * kSlots]   twiddles of one chunk (re, im)
//   rows  [kRows * kBands]        band rows in window order p
constexpr int kBigFloats = 2 * kRows * kGStride;   // 8448 >= 8192 keys' floats
constexpr int kTwFloats = 2 * kChunk * kSlots;
constexpr int kRowsFloats = kRows * kBands;

__global__ void __launch_bounds__(kThreads)
fused_rows_kernel(const float* __restrict__ audio, long long t_len, int n_tiles,
                  int hop, int span_pad,
                  const float* __restrict__ c16, const float* __restrict__ s16,
                  const float* __restrict__ t2a, const float* __restrict__ proj_r,
                  int k_max, const float* __restrict__ perm,
                  const float* __restrict__ h_cols_t, float inv_div,
                  float* __restrict__ coeffs_out, int* __restrict__ cls_out) {
  extern __shared__ float smem[];
  float* span = smem;
  float* big = span + span_pad;
  float* g_re = big;
  float* g_im = big + kRows * kGStride;
  float* tw_re = big + kBigFloats;
  float* tw_im = tw_re + kChunk * kSlots;
  float* rows = tw_re + kTwFloats;

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int clip = blockIdx.y;
  const int vper = kB / hop;               // windows per 128 samples
  const int wper = kRows / vper;

  // ---- audio span of this tile -------------------------------------------
  const long long base = static_cast<long long>(tile) * kRows * hop;
  const float* clip_audio = audio + static_cast<long long>(clip) * t_len;
  const int span_len = hop * (kRows - 1) + kWindow;
  for (int i = tid; i < span_pad; i += kThreads) {
    const long long t = base + i;
    span[i] = (i < span_len && t < t_len) ? clip_audio[t] : 0.0f;
  }

  // Stage-1 role: lane bb of a chunk, windows p = pg + 8 i.
  const int s1_bb = tid & 31;
  const int s1_pg = tid >> 5;
  // Stage-2 role: windows p = s2_jg * 4 + q, slots s2_sg * 6 + s.
  const int s2_sg = tid & 7;
  const int s2_jg = tid >> 3;
  // Projection / Haar role: band (or Haar column) pj_k, rows p = pj_pg + 8 i.
  const int pj_k = tid & 31;
  const int pj_pg = tid >> 5;

  float row_acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) row_acc[i] = 0.0f;

  for (int r = 0; r < kA; ++r) {
    float cr[kA], ci[kA];
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      cr[a] = __ldg(c16 + a * kA + r);
      ci[a] = __ldg(s16 + a * kA + r);
    }
    float acc_re[kWinPerThread][kSlotPerThread];
    float acc_im[kWinPerThread][kSlotPerThread];
#pragma unroll
    for (int q = 0; q < kWinPerThread; ++q) {
#pragma unroll
      for (int s = 0; s < kSlotPerThread; ++s) {
        acc_re[q][s] = 0.0f;
        acc_im[q][s] = 0.0f;
      }
    }

    for (int b0 = 0; b0 < kB; b0 += kChunk) {
      __syncthreads();   // span loaded / previous readers of big and tw done
      // Stage 1 for this chunk: G_r[p][bb] = sum_a x_p[a*128 + b0 + bb] w_r[a].
      for (int i = 0; i < kRows / 8; ++i) {
        const int p = s1_pg + 8 * i;
        const int j = (p % wper) * vper + p / wper;   // natural window index
        const float* x = span + j * hop + b0 + s1_bb;
        float gr = 0.0f, gi = 0.0f;
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          const float xv = x[a * kB];
          gr = fmaf(xv, cr[a], gr);
          gi = fmaf(xv, ci[a], gi);
        }
        g_re[p * kGStride + s1_bb] = gr;
        g_im[p * kGStride + s1_bb] = gi;
      }
      // This chunk's twiddles, slots padded to kSlots with zeros.
      for (int e = tid; e < kChunk * kSlots; e += kThreads) {
        const int bb = e / kSlots;
        const int s = e % kSlots;
        const float* t = t2a + (static_cast<size_t>(r) * kB + b0 + bb) * (2 * kHalf);
        tw_re[e] = s < k_max ? __ldg(t + s) : 0.0f;
        tw_im[e] = s < k_max ? __ldg(t + kHalf + s) : 0.0f;
      }
      __syncthreads();
      // Stage 2: complex register tile.
      for (int bb = 0; bb < kChunk; ++bb) {
        float gr[kWinPerThread], gi[kWinPerThread];
#pragma unroll
        for (int q = 0; q < kWinPerThread; ++q) {
          const int p = s2_jg * kWinPerThread + q;
          gr[q] = g_re[p * kGStride + bb];
          gi[q] = g_im[p * kGStride + bb];
        }
        float tr[kSlotPerThread], ti[kSlotPerThread];
#pragma unroll
        for (int s = 0; s < kSlotPerThread; ++s) {
          tr[s] = tw_re[bb * kSlots + s2_sg * kSlotPerThread + s];
          ti[s] = tw_im[bb * kSlots + s2_sg * kSlotPerThread + s];
        }
#pragma unroll
        for (int q = 0; q < kWinPerThread; ++q) {
#pragma unroll
          for (int s = 0; s < kSlotPerThread; ++s) {
            acc_re[q][s] = fmaf(gr[q], tr[s], acc_re[q][s]);
            acc_re[q][s] = fmaf(-gi[q], ti[s], acc_re[q][s]);
            acc_im[q][s] = fmaf(gr[q], ti[s], acc_im[q][s]);
            acc_im[q][s] = fmaf(gi[q], tr[s], acc_im[q][s]);
          }
        }
      }
    }

    // Q5, |X|^2 and non-finite -> 0, into V [kRows][kSlots] (over G).
    __syncthreads();
    float* v = big;
#pragma unroll
    for (int q = 0; q < kWinPerThread; ++q) {
#pragma unroll
      for (int s = 0; s < kSlotPerThread; ++s) {
        float xr = acc_re[q][s];
        float xi = acc_im[q][s];
        xr = xr > 0.0f ? xr * inv_div : xr;
        xi = xi > 0.0f ? xi * inv_div : xi;
        float e = xr * xr + xi * xi;
        e = isfinite(e) ? e : 0.0f;
        v[(s2_jg * kWinPerThread + q) * kSlots + s2_sg * kSlotPerThread + s] = e;
      }
    }
    __syncthreads();
    // Band projection of residue r: rows[p][k] += sum_slot V[p][slot] P_r[slot][k].
    for (int slot = 0; slot < k_max; ++slot) {
      const float pw = __ldg(proj_r + (static_cast<size_t>(r) * kHalf + slot) * kBands + pj_k);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        row_acc[i] = fmaf(v[(pj_pg + 8 * i) * kSlots + slot], pw, row_acc[i]);
      }
    }
  }

  // ---- 2-D Haar: C = perm . rows . H32^T ----------------------------------
#pragma unroll
  for (int i = 0; i < 16; ++i) rows[(pj_pg + 8 * i) * kBands + pj_k] = row_acc[i];
  __syncthreads();
  float* t1 = big;                                   // [kRows][kBands]
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int p = pj_pg + 8 * i;
    float acc = 0.0f;
    for (int c = 0; c < kBands; ++c) {
      acc = fmaf(rows[p * kBands + c], __ldg(h_cols_t + c * kBands + pj_k), acc);
    }
    t1[p * kBands + pj_k] = acc;
  }
  __syncthreads();
  float coeff[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int q = pj_pg + 8 * i;
    const float* prow = perm + q * kRows;
    float acc = 0.0f;
    for (int p = 0; p < kRows; ++p) {
      acc = fmaf(__ldg(prow + p), t1[p * kBands + pj_k], acc);
    }
    coeff[i] = acc;
  }

  const size_t frame = static_cast<size_t>(clip) * n_tiles + tile;
  if (coeffs_out != nullptr) {
    float* out = coeffs_out + frame * kRows * kBands;
#pragma unroll
    for (int i = 0; i < 16; ++i) out[(pj_pg + 8 * i) * kBands + pj_k] = coeff[i];
    return;
  }
  __syncthreads();                                   // t1 readers done
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(big);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int idx = (pj_pg + 8 * i) * kBands + pj_k;   // row-major flat index
    keys[idx] = lbad::select_key(coeff[i], idx);
  }
  __syncthreads();
  lbad::select_top128(keys, cls_out + frame * lbad::kTop);
}

}  // namespace

extern "C" int lbad_fused_rows_smem_bytes(int hop) {
  const int span_len = hop * (kRows - 1) + kWindow;
  const int span_pad = (span_len + 3) / 4 * 4;
  return static_cast<int>((span_pad + kBigFloats + kTwFloats + kRowsFloats)
                          * sizeof(float));
}

// coeffs_out or cls_out (exactly one non-null) selects the output mode.
extern "C" int lbad_fused_rows(const float* audio, int batch, long long t_len,
                               int n_tiles, int hop, const float* c16,
                               const float* s16, const float* t2a,
                               const float* proj_r, int k_max, const float* perm,
                               const float* h_cols_t, float inv_div,
                               float* coeffs_out, int* cls_out, void* stream) {
  if (hop <= 0 || kB % hop != 0 || k_max <= 0 || k_max > kSlots
      || (coeffs_out == nullptr) == (cls_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const int smem = lbad_fused_rows_smem_bytes(hop);
  const int span_pad = smem / static_cast<int>(sizeof(float))
                       - kBigFloats - kTwFloats - kRowsFloats;
  cudaError_t err = cudaFuncSetAttribute(
      fused_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_tiles, batch);
  fused_rows_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      audio, t_len, n_tiles, hop, span_pad, c16, s16, t2a, proj_r, k_max, perm,
      h_cols_t, inv_div, coeffs_out, cls_out);
  return static_cast<int>(cudaGetLastError());
}
