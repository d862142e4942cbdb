// Standalone top-128 sign-class select: [N, 4096] f32 -> [N, 128] i32.
//
// Replaces the TPU kernel lbaudiodetective_tpu/ops/pallas/select_signs.py
// :: select_sign_classes (_select_kernel / _select_body), and with it the
// select tail kernel of the v3 rows kernel (fused_rows_v2.py,
// _tail_kernel).
//
// Bound on the H100: device memory.  Each frame is read once (16 KB) and
// 512 B are written: at [14336, 4096] that is 234.9 MB in and 7.3 MB out,
// 0.072 ms at 3.35 TB/s.  The select itself is O(N) integer work in shared
// memory (select_signs.cuh: a radix threshold select of at most four
// histogram passes, a ballot compaction and a 128-key rank count).
//
// Design: one CTA of 256 threads per frame, so nothing carries between
// blocks (the TPU kernel's 32-frame blocks and lane-roll merge-prune tree
// were shaped by its 128-lane vector unit).  The 4096 keys (32 KB) sit in
// shared memory (37 KB with the select's scratch), so six CTAs share an SM
// and hide each other's barriers and loads.  The select is exact in
// integers, so the result is element-exact against the stable sort.
#include <cuda_runtime.h>

#include "select_signs.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
select_sign_classes_kernel(const float* __restrict__ x, int* __restrict__ out) {
  __shared__ unsigned long long keys[lbad::kFrame];
  __shared__ unsigned long long scratch[lbad::kSelectScratchWords];
  const float* frame = x + static_cast<size_t>(blockIdx.x) * lbad::kFrame;
  for (int i = threadIdx.x; i < lbad::kFrame; i += blockDim.x) {
    keys[i] = lbad::select_key(frame[i], i);
  }
  __syncthreads();
  lbad::select_top128<kThreads>(keys, out + static_cast<size_t>(blockIdx.x) * lbad::kTop,
                                scratch);
}

}  // namespace

extern "C" int lbad_select_sign_classes(const float* x, int n_frames, int* out,
                                        void* stream) {
  if (n_frames > 0) {
    select_sign_classes_kernel<<<n_frames, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(x, out);
  }
  return static_cast<int>(cudaGetLastError());
}
