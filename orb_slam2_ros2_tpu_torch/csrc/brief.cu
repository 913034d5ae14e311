// Oriented-BRIEF descriptors from the angle bin each keypoint uses (K3).
//
// Replaces no TPU kernel.  The JAX package (orb_slam2_ros2_tpu/ops/brief.py,
// describe) leaves this step to XLA as one dense product: patches [N, 3072]
// times the folded-blur matrix D [3072, 8192] (32 angle bins x 256 pairs),
// then a gather keeps the bin each keypoint's angle selects.  On the card that
// was a cuBLAS f32 GEMM, and it threw away 31/32 of what it computed.  Each
// column of D is two 7x7 Gaussian stamps, so at most 98 of its 3072 rows are
// nonzero.  K3 computes, for each patch, only the 256 sums of its own bin,
// each from its column's nonzero taps.  It also does the bf16 rounding of the
// patch, the bin gather, the > 0 test and the bit packing.
//
// Arithmetic.  Each product bf16(patch) x bf16(D) is exact in f32.  A column's
// taps are summed in f32 in ascending row order, one tap after another, as a
// sequential dot product over all 3072 rows would (its zero terms add
// nothing).  So a bit can differ from the dense product only by the order of
// its sum.  bit i of word w is pair 32w + i's sum > 0, as ops/brief.py's
// pack_bits lays it out.
//
// What bounds it on an H100.  Reading the f32 patches once: 50.33 MB for
// 4096 patches, 15 us at 3.35 TB/s.  The arithmetic (256 x 98 multiply-adds a
// patch) is small; shared memory is not, since every tap reads a patch value
// at a place the template sets, and 32 such places in a warp collide on its
// banks.  Design:
//   * one 8-warp block stages one patch at a time in shared memory as bf16
//     pairs (the rounding happens there), in four copies, copy k shifted by k
//     words, so that any 7 taps of a row lie in one 16-byte word of some copy;
//   * thread i walks pair i's column as 14 row segments of 7 taps (one int32
//     a segment, from ops/brief.py's segment table: L2-resident, coalesced
//     across the warp), in ascending row order;
//   * a segment costs two 16-byte shared loads: its 7 values (realigned by a
//     funnel shift) and its 7 bf16 weights, a row of the weight table (a few
//     hundred rows: the stamps' values, and the rows where the two stamps
//     overlap).  A tap that the segment before already took has weight 0: it
//     adds +-0, which changes no sum and no bit;
//   * warp w's ballot is descriptor word w;
//   * blocks persist and stride over the patches, so the weight table is
//     staged once a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PATCH_ROWS = 48;
constexpr int PATCH_PX = PATCH_ROWS * 64;
constexpr int N_PAIRS = 256;
constexpr int N_SEGS = 14;
constexpr int TAPS = 7;
constexpr int THREADS = 256;
constexpr int MAX_WEIGHT_ROWS = 1024;
constexpr int COPIES = 4;
constexpr int ROW_WORDS = 36;  // 32 words of bf16 pairs a row + the copies' shift; 16-byte aligned rows
constexpr int COPY_WORDS = PATCH_ROWS * ROW_WORDS;

static_assert(THREADS == N_PAIRS && PATCH_PX % (4 * THREADS) == 0, "one thread a pair");
static_assert(ROW_WORDS % 4 == 0 && ROW_WORDS >= 32 + COPIES - 1, "16-byte rows");

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// patches f32 [N, 48, 64]; bins int32 [N]; segs [32, 14, 256] segment words
// (bits 0-5 row, 6-11 first column, 12-21 weight row); weights [n_weights]
// rows of 8 bf16; out int32 [N, 8].  Dynamic shared memory: the weight rows.
__global__ void __launch_bounds__(THREADS)
brief_kernel(const float* __restrict__ patches, const int* __restrict__ bins,
             const uint32_t* __restrict__ segs, const uint4* __restrict__ weights, int n_weights,
             int* __restrict__ out, int N) {
  __shared__ uint4 sp[COPIES * COPY_WORDS / 4];  // copy k holds a row's word j at j + k
  extern __shared__ uint4 swt[];
  uint32_t* spw = reinterpret_cast<uint32_t*>(sp);
  const int t = threadIdx.x;
  for (int i = t; i < n_weights; i += THREADS) swt[i] = weights[i];

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    __syncthreads();  // the weights are in; the last patch's reads are done
    const float4* src = reinterpret_cast<const float4*>(patches + static_cast<size_t>(n) * PATCH_PX);
#pragma unroll
    for (int i = t; i < PATCH_PX / 4; i += THREADS) {  // 16 float4 a row
      const float4 v = src[i];
      const uint32_t p0 = bf16_pair(v.x, v.y), p1 = bf16_pair(v.z, v.w);
      uint32_t* dst = spw + (i >> 4) * ROW_WORDS + ((i & 15) << 1);
#pragma unroll
      for (int k = 0; k < COPIES; ++k) {
        dst[k * COPY_WORDS + k] = p0;
        dst[k * COPY_WORDS + k + 1] = p1;
      }
    }
    const uint32_t* col = segs + static_cast<size_t>(bins[n]) * N_SEGS * N_PAIRS + t;
    __syncthreads();

    float s = 0.f;
#pragma unroll 2
    for (int k = 0; k < N_SEGS; ++k) {
      const uint32_t d = __ldg(col + k * N_PAIRS);
      const uint32_t y = d & 63u, x = (d >> 6) & 63u, wi = x >> 1, cp = (0u - wi) & 3u;
      const uint4 q = sp[(cp * COPY_WORDS + y * ROW_WORDS + wi + cp) >> 2];  // words wi .. wi + 3
      const uint4 wr = swt[d >> 12];
      const uint32_t sh = (x & 1u) << 4;
      const uint32_t a0 = __funnelshift_r(q.x, q.y, sh), a1 = __funnelshift_r(q.y, q.z, sh),
                     a2 = __funnelshift_r(q.z, q.w, sh), a3 = q.w >> sh;
      const float v[TAPS] = {lo(a0), hi(a0), lo(a1), hi(a1), lo(a2), hi(a2), lo(a3)};
      const float wt[TAPS] = {lo(wr.x), hi(wr.x), lo(wr.y), hi(wr.y), lo(wr.z), hi(wr.z), lo(wr.w)};
#pragma unroll
      for (int c = 0; c < TAPS; ++c) s = __fmaf_rn(v[c], wt[c], s);
    }
    const unsigned word = __ballot_sync(0xffffffffu, s > 0.f);
    if ((t & 31) == 0) out[static_cast<size_t>(n) * 8 + (t >> 5)] = static_cast<int>(word);
  }
}

}  // namespace

// patches: f32 [N, 48, 64]; bins: int32 [N]; segs: int32 [32, 14, 256];
// weights: int32 [n_weights, 4]; out: int32 [N, 8].  Returns cudaGetLastError().
extern "C" int brief_describe(const void* patches, const void* bins, const void* segs, const void* weights,
                              int n_weights, void* out, int N, void* stream) {
  if (n_weights < 1 || n_weights > MAX_WEIGHT_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n_weights) * sizeof(uint4);
  static int grid_cap[MAX_WEIGHT_ROWS + 1] = {};  // resident blocks on the card, by table size
  if (grid_cap[n_weights] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, brief_kernel, THREADS, smem);
    if (sms < 1 || per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_cap[n_weights] = sms * per_sm;
  }
  if (N > 0) {
    const int grid = N < grid_cap[n_weights] ? N : grid_cap[n_weights];
    brief_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(patches), static_cast<const int*>(bins), static_cast<const uint32_t*>(segs),
        static_cast<const uint4*>(weights), n_weights, static_cast<int*>(out), N);
  }
  return static_cast<int>(cudaGetLastError());
}
