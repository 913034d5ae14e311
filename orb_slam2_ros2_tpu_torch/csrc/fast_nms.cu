// FAST-9/16 corner score with optional fused 3x3 non-max suppression, bf16.
//
// Replaces the TPU kernel orb_slam2_ros2_tpu/ops/pallas_fast.py
// (fast_score_pallas, body _kernel / _arc_scores).  The result is bit-exact
// against the plain PyTorch version in orb_slam2_ros2_tpu_torch/ops/fast.py,
// nms3(fast_score(x, th)), on every pixel, borders included:
//   * ring pixels wrap around the image (index modulo H and W), as the plain
//     version's torch.roll does;
//   * the NMS window skips out-of-image neighbours, as the -inf padding of
//     nms3 does (the Pallas kernel zero-pads instead; its 23 px keypoint
//     border hid that difference);
//   * every ring difference is a bf16 subtraction (computed in f32, rounded
//     to bf16 nearest-even) before the min/max tree; the threshold compare
//     is in f32.
//
// What bounds it on an H100: memory.  Per pixel it reads one bf16 and writes
// one bf16 (~4 bytes), against ~200 min/max/sub operations that the SMs
// absorb easily.  Design: one thread per output pixel; each 32x8 block stages
// its tile with a +-4 px halo (ring radius 3 + NMS radius 1) in shared memory
// once, scores the tile plus a 1 px score halo from shared memory, and
// suppresses from a second shared tile, so device memory sees each input
// pixel ~2.5 times (halo overlap, mostly L2 hits) and each output once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;   // output tile width  (threads in x)
constexpr int TH = 8;    // output tile height (threads in y)
constexpr int HALO = 4;  // ring radius 3 + NMS radius 1
constexpr int IW = TW + 2 * HALO;
constexpr int IH = TH + 2 * HALO;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// max over the 16 circular arcs of the min over 9 consecutive entries (the
// doubling tree of _arc_scores; min/max are exact, so any order agrees)
__device__ __forceinline__ float arc_score(const float v[16]) {
  float m1[16], m2[16], m4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m1[k] = fminf(v[k], v[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m2[k] = fminf(m1[k], m1[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m4[k] = fminf(m2[k], m2[(k + 4) & 15]);
  float out = -INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) out = fmaxf(out, fminf(m4[k], v[(k + 8) & 15]));
  return out;
}

// thresholded FAST score of tile pixel (ty, tx); tile values are bf16 in f32
__device__ __forceinline__ float score_at(const float (*tile)[IW], int ty, int tx, float th) {
  // Bresenham ring of radius 3, clockwise from 12 o'clock (ops/fast.py CIRCLE_OFFSETS)
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float c = tile[ty][tx];
  float d[16], nd[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    d[k] = bf16_round(tile[ty + dy[k]][tx + dx[k]] - c);
    nd[k] = -d[k];
  }
  const float s = fmaxf(arc_score(d), arc_score(nd));
  return s > th ? s : 0.0f;
}

template <bool NMS>
__global__ void __launch_bounds__(TW * TH)
fast_nms_kernel(const __nv_bfloat16* __restrict__ in, __nv_bfloat16* __restrict__ out,
                int H, int W, float th) {
  constexpr int E = NMS ? 1 : 0;  // score halo for the suppression window
  constexpr int SW = TW + 2 * E;
  constexpr int SH = TH + 2 * E;
  __shared__ float tile[IH][IW];
  __shared__ float sc[SH][SW];

  const size_t plane = (size_t)H * W;
  const __nv_bfloat16* img = in + blockIdx.z * plane;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;

  for (int i = tid; i < IH * IW; i += TW * TH) {
    const int ty = i / IW, tx = i % IW;
    int gy = (y0 + ty - HALO) % H;
    int gx = (x0 + tx - HALO) % W;
    gy += gy < 0 ? H : 0;
    gx += gx < 0 ? W : 0;
    tile[ty][tx] = __bfloat162float(img[(size_t)gy * W + gx]);
  }
  __syncthreads();

  for (int i = tid; i < SH * SW; i += TW * TH) {
    const int sy = i / SW, sx = i % SW;
    const int gy = y0 + sy - E, gx = x0 + sx - E;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    sc[sy][sx] = inside ? score_at(tile, sy - E + HALO, sx - E + HALO, th) : -INFINITY;
  }
  __syncthreads();

  const int gy = y0 + threadIdx.y, gx = x0 + threadIdx.x;
  if (gy >= H || gx >= W) return;
  float s = sc[threadIdx.y + E][threadIdx.x + E];
  if (NMS) {
    float m = -INFINITY;
#pragma unroll
    for (int oy = 0; oy < 3; ++oy)
#pragma unroll
      for (int ox = 0; ox < 3; ++ox) m = fmaxf(m, sc[threadIdx.y + oy][threadIdx.x + ox]);
    s = s >= m ? s : 0.0f;
  }
  out[blockIdx.z * plane + (size_t)gy * W + gx] = __float2bfloat16_rn(s);
}

}  // namespace

// in, out: bf16 [B, H, W] contiguous on the device.  Returns cudaGetLastError().
extern "C" int fast_nms_bf16(const void* in, void* out, int B, int H, int W, float th,
                             int nms, void* stream) {
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const auto* src = static_cast<const __nv_bfloat16*>(in);
  auto* dst = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (nms)
    fast_nms_kernel<true><<<grid, block, 0, st>>>(src, dst, H, W, th);
  else
    fast_nms_kernel<false><<<grid, block, 0, st>>>(src, dst, H, W, th);
  return static_cast<int>(cudaGetLastError());
}
