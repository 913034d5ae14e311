// Keypoint patch gather: 48x64 windows of the bf16 pyramid canvas, to f32.
//
// Replaces the TPU kernel orb_slam2_ros2_tpu/ops/pallas_patches.py
// (extract_patches_pallas, body _kernel).  For each centre (y, x) the window
// origin is (clip(y - 22, 0, H - 56), clip(x - 22, 0, W - 256)), then clamped
// into the canvas as dynamic_slice does.  The 56/256 bounds come from the
// TPU's aligned DMA window, but they define the output, so they stay; the
// TPU-only parts (8/128-aligned DMA origins, one-hot shift matmuls,
// 2048-centre chunking) are gone.  Bit-identical to the plain PyTorch
// version in orb_slam2_ros2_tpu_torch/ops/patches.py (a bf16 -> f32 copy is
// exact).
//
// What bounds it on an H100: memory.  It is a pure copy: at the main-path
// shape (4096 centres) ~25 MB of bf16 read and 50 MB of f32 written per
// frame, no arithmetic.  Design: one block per patch, consecutive threads on
// consecutive columns of a row, so every warp reads 64 contiguous bytes and
// writes 128 contiguous bytes; 256 threads cover the 3072 elements in 12
// strided steps, with no shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int PATCH_ROWS = 48;
constexpr int PATCH_COLS = 64;
constexpr int CENTER = 22;
constexpr int WIN_ROWS = 56;   // the TPU DMA window the clamp is defined by
constexpr int WIN_COLS = 256;
constexpr int THREADS = 256;

__device__ __forceinline__ int clip(int v, int lo, int hi) { return min(max(v, lo), hi); }

__global__ void __launch_bounds__(THREADS)
patches_kernel(const __nv_bfloat16* __restrict__ canvas, const int* __restrict__ centers,
               float* __restrict__ out, int H, int W) {
  const int n = blockIdx.x;
  const int cy = centers[2 * n], cx = centers[2 * n + 1];
  const int y = clip(clip(cy - CENTER, 0, H - WIN_ROWS), 0, H - PATCH_ROWS);
  const int x = clip(clip(cx - CENTER, 0, W - WIN_COLS), 0, W - PATCH_COLS);
  const __nv_bfloat16* src = canvas + (size_t)y * W + x;
  float* dst = out + (size_t)n * PATCH_ROWS * PATCH_COLS;
#pragma unroll 4
  for (int i = threadIdx.x; i < PATCH_ROWS * PATCH_COLS; i += THREADS) {
    const int r = i / PATCH_COLS, c = i % PATCH_COLS;
    dst[i] = __bfloat162float(src[(size_t)r * W + c]);
  }
}

}  // namespace

// canvas: bf16 [H, W]; centers: int32 [N, 2] (y, x); out: f32 [N, 48, 64].
// Returns cudaGetLastError().
extern "C" int extract_patches_bf16(const void* canvas, const void* centers, void* out, int N,
                                    int H, int W, void* stream) {
  if (N > 0) {
    patches_kernel<<<N, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(canvas), static_cast<const int*>(centers),
        static_cast<float*>(out), H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
