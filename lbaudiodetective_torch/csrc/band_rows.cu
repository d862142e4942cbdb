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
//  - fused_rows_v2.py :: fused_band_rows_v2 (_rows_kernel_v2): rows, or with
//    fuse_haar the coefficients, at an integer hop;
//  - fused_rows_v2.py :: fused_band_rows_v3 with fuse_haar at the frame
//    geometries that csrc/fused_rows.cu does not take (rows_per_frame != 128,
//    pitch_step_count != 32).
// It computes what fused_rows.py::_rows_kernel computes: window sample
// n = 128 a + b; stage-1 DFT over a (16 taps, c16/s16); per residue r the
// stage-2 twiddles over b (t_re/t_im [16, 128, k_max], the vDSP 2x folded
// in); quirk Q5 (positive parts x 1/divisor); |X|^2 with non-finite values
// set to 0; the band projection (proj_perm, row r * k_max + slot, 1/width
// folded in).
//
// Bound on the H100: float32 FMA throughput, as fused_rows.cu.  Stage 2 is a
// complex [windows x 128 b] @ [128 b x k_max slots] product per residue,
// about 45 M FMA per 128 windows at k_max 43; stage 1, the projection and
// the Haar products add about a quarter of that.  Device memory moves one
// audio span in and 16 KB of rows out per 128 windows.
//
// Design:
//  - Window starts come from a device table (FingerprintConfig.row_starts:
//    a float64 floor on the host) and are never recomputed on the device, so
//    fractional and integer hops share one code path and no start drifts.
//  - One CTA per (tile, clip).  A tile is one frame of rows_per_frame rows
//    (coefficients) or `sub` rows (rows mode).  Its windows run in sub-tiles
//    of `sub` <= 128 windows; each sub-tile's audio span (start of its last
//    window - start of its first + 2048 samples, zero past T) is staged in
//    shared memory.  The host picks the largest `sub` whose span fits, so
//    large hops and large frames split instead of failing.
//  - Per residue, per pass of 48 slots of k_max and per 32-wide chunk of b,
//    the CTA builds stage 1 G_r[window][b] in shared memory from the span and
//    stages the chunk's twiddles; each thread then accumulates a 4-window x
//    6-slot complex register tile.  Plain FP32 FMA: no TF32, no bf16 split.
//  - Q5, |X|^2 and the projection run per residue and slot pass from shared
//    memory; each thread owns 16 fixed (window, band) sums, so every sum has
//    a fixed order and two runs give identical bits (no atomics).
//  - Coefficients: the frame's rows stay in shared memory; the column pass
//    (x H_bands^T) goes through the stage-1 region in chunks of rows, and the
//    row pass (H_rpf x) reads H_rpf through the read-only cache and writes
//    the output.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 2048;
constexpr int kA = 16;            // stage-1 length (n = a * 128 + b)
constexpr int kB = 128;           // stage-2 length
constexpr int kTile = 128;        // most windows in one sub-tile
constexpr int kChunk = 32;        // b values per stage-2 chunk
constexpr int kGStride = kChunk + 1;
constexpr int kSlots = 48;        // slots per stage-2 pass
constexpr int kWinPerThread = 4;
constexpr int kSlotPerThread = 6;
constexpr int kAcc = 16;          // (window, band) sums per thread
constexpr int kBigFloats = 2 * kTile * kGStride;
constexpr int kTwFloats = 2 * kChunk * kSlots;

static_assert(kTile == (kThreads / 8) * kWinPerThread, "stage-2 window groups");
static_assert(kSlots == 8 * kSlotPerThread, "stage-2 slot groups");
static_assert(kTile * kSlots <= kBigFloats, "V fits over G");

// Shared-memory plan, in 4-byte words:
//   span   [span_pad]             audio of the sub-tile
//   big    [kBigFloats]           G_re/G_im of one chunk; reused as V
//                                 [kTile][kSlots] and as the column-pass scratch
//   tw     [kTwFloats]            twiddles of one chunk (re, im)
//   offs   [kTile] int            window offsets in the span
//   frame  [tile_rows * bands]    coefficients mode: the frame's rows
__global__ void __launch_bounds__(kThreads)
band_rows_kernel(const float* __restrict__ audio, long long t_len,
                 const int* __restrict__ starts, int n_rows, int tile_rows,
                 int sub, int bands, int k_max, int span_pad,
                 const float* __restrict__ c16, const float* __restrict__ s16,
                 const float* __restrict__ t_re, const float* __restrict__ t_im,
                 const float* __restrict__ proj, const float* __restrict__ h_rows,
                 const float* __restrict__ h_cols_t, float inv_div,
                 float* __restrict__ out) {
  extern __shared__ float smem[];
  float* span = smem;
  float* big = span + span_pad;
  float* g_re = big;
  float* g_im = big + kTile * kGStride;
  float* tw_re = big + kBigFloats;
  float* tw_im = tw_re + kChunk * kSlots;
  int* offs = reinterpret_cast<int*>(tw_re + kTwFloats);
  float* frame = reinterpret_cast<float*>(offs + kTile);

  const bool coeffs = h_rows != nullptr;
  const int tid = threadIdx.x;
  const int clip = blockIdx.y;
  const int tile_row0 = blockIdx.x * tile_rows;
  const float* clip_audio = audio + static_cast<long long>(clip) * t_len;
  float* clip_out = out + static_cast<size_t>(clip) * n_rows * bands;

  // Stage-1 role: lane bb of a chunk, windows p = s1_pg + 8 i.
  const int s1_bb = tid & 31;
  const int s1_pg = tid >> 5;
  // Stage-2 role: windows p = s2_jg * 4 + q, slots s2_sg * 6 + s.
  const int s2_sg = tid & 7;
  const int s2_jg = tid >> 3;

  for (int st = 0; st < tile_rows; st += sub) {
    const int row0 = tile_row0 + st;
    if (row0 >= n_rows) break;                   // ragged last rows tile
    const int n_valid = min(sub, n_rows - row0);
    const int base = __ldg(starts + row0);
    const int span_len = __ldg(starts + row0 + n_valid - 1) - base + kWindow;
    const bool s2_active = s2_jg * kWinPerThread < sub;

    __syncthreads();                             // previous sub-tile's readers done
    for (int p = tid; p < kTile; p += kThreads) {
      offs[p] = p < n_valid ? __ldg(starts + row0 + p) - base : 0;
    }
    for (int i = tid; i < span_pad; i += kThreads) {
      const long long t = static_cast<long long>(base) + i;
      span[i] = (i < span_len && t < t_len) ? clip_audio[t] : 0.0f;
    }

    float row_acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) row_acc[i] = 0.0f;

    for (int r = 0; r < kA; ++r) {
      float cr[kA], ci[kA];
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        cr[a] = __ldg(c16 + a * kA + r);
        ci[a] = __ldg(s16 + a * kA + r);
      }
      for (int s0 = 0; s0 < k_max; s0 += kSlots) {
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
          __syncthreads();       // span staged / previous readers of big and tw done
          // Stage 1: G_r[p][bb] = sum_a x_p[a * 128 + b0 + bb] w_r[a].
          for (int p = s1_pg; p < sub; p += kThreads / 32) {
            const float* x = span + offs[p] + b0 + s1_bb;
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
          // This chunk's twiddles for slots [s0, s0 + kSlots), zero past k_max.
          for (int e = tid; e < kChunk * kSlots; e += kThreads) {
            const int bb = e / kSlots;
            const int slot = s0 + e % kSlots;
            const size_t idx = (static_cast<size_t>(r) * kB + b0 + bb) * k_max + slot;
            tw_re[e] = slot < k_max ? __ldg(t_re + idx) : 0.0f;
            tw_im[e] = slot < k_max ? __ldg(t_im + idx) : 0.0f;
          }
          __syncthreads();
          if (s2_active) {
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
        }

        // Q5, |X|^2 and non-finite -> 0, into V [kTile][kSlots] (over G).
        __syncthreads();
        float* v = big;
        if (s2_active) {
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
        }
        __syncthreads();
        // Band projection of this residue's slots [s0, s0 + n_slots).
        const int n_slots = min(kSlots, k_max - s0);
        const float* pr = proj + (static_cast<size_t>(r) * k_max + s0) * bands;
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int e = tid + i * kThreads;
          if (e < sub * bands) {
            const int p = e / bands;
            const int k = e - p * bands;
            float acc = row_acc[i];
            for (int slot = 0; slot < n_slots; ++slot) {
              acc = fmaf(v[p * kSlots + slot], __ldg(pr + slot * bands + k), acc);
            }
            row_acc[i] = acc;
          }
        }
      }
    }

    // Rows of this sub-tile: to the output, or into the frame.
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      if (coeffs) {
        if (e < sub * bands) frame[st * bands + e] = row_acc[i];
      } else if (e < n_valid * bands) {
        clip_out[static_cast<size_t>(row0) * bands + e] = row_acc[i];
      }
    }
  }
  if (!coeffs) return;

  // ---- 2-D Haar of the frame: C = H_rpf . (F . H_bands^T) -----------------
  __syncthreads();
  const int chunk_rows = min(tile_rows, kBigFloats / bands);
  for (int c0 = 0; c0 < tile_rows; c0 += chunk_rows) {
    const int n = min(chunk_rows, tile_rows - c0) * bands;
    for (int e = tid; e < n; e += kThreads) {
      const int p = c0 + e / bands;
      const int k = e % bands;
      const float* f = frame + p * bands;
      float acc = 0.0f;
      for (int c = 0; c < bands; ++c) {
        acc = fmaf(f[c], __ldg(h_cols_t + c * bands + k), acc);
      }
      big[e] = acc;
    }
    __syncthreads();
    for (int e = tid; e < n; e += kThreads) frame[c0 * bands + e] = big[e];
    __syncthreads();
  }
  for (int e = tid; e < tile_rows * bands; e += kThreads) {
    const int q = e / bands;
    const int k = e % bands;
    const float* h = h_rows + static_cast<size_t>(q) * tile_rows;
    float acc = 0.0f;
    for (int p = 0; p < tile_rows; ++p) {
      acc = fmaf(__ldg(h + p), frame[p * bands + k], acc);
    }
    clip_out[static_cast<size_t>(tile_row0) * bands + e] = acc;
  }
}

}  // namespace

// Bytes of dynamic shared memory the kernel needs for sub-tiles of `sub`
// windows of `bands` bands whose audio spans take span_pad floats;
// frame_floats is rows_per_frame * bands in coefficients mode and 0 in rows
// mode.  -1 when the kernel takes no such sub-tile (more than kTile windows,
// or more (window, band) sums than its threads own).
extern "C" long long lbad_band_rows_smem_bytes(int sub, int bands, int span_pad,
                                               int frame_floats) {
  if (sub < 1 || sub > kTile || bands < 1 || sub * bands > kAcc * kThreads) return -1;
  return (static_cast<long long>(span_pad) + kBigFloats + kTwFloats + kTile
          + frame_floats) * 4;
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
extern "C" int lbad_band_rows(const float* audio, int batch, long long t_len,
                              const int* starts, int n_rows, int tile_rows,
                              int sub, int bands, int k_max, int span_pad,
                              const float* c16, const float* s16,
                              const float* t_re, const float* t_im,
                              const float* proj, const float* h_rows,
                              const float* h_cols_t, float inv_div, float* out,
                              void* stream) {
  const bool coeffs = h_rows != nullptr;
  const long long smem = lbad_band_rows_smem_bytes(sub, bands, span_pad,
                                                   coeffs ? tile_rows * bands : 0);
  if ((h_rows == nullptr) != (h_cols_t == nullptr) || smem < 0 || k_max < 1
      || span_pad < kWindow || tile_rows < sub || tile_rows % sub != 0
      || (!coeffs && tile_rows != sub) || (coeffs && n_rows % tile_rows != 0)) {
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
      s16, t_re, t_im, proj, h_rows, h_cols_t, inv_div, out);
  return static_cast<int>(cudaGetLastError());
}
