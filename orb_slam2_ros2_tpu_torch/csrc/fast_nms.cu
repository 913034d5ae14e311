// FAST-9/16 corner score with optional fused 3x3 non-max suppression over a
// whole row-stacked pyramid canvas, bf16: one launch scores every level of
// every image of a frame.
//
// Replaces the TPU kernel orb_slam2_ros2_tpu/ops/pallas_fast.py
// (fast_score_pallas, pallas_call at :109; body _kernel / _arc_scores), which
// runs once per level.  The result is bit-exact against the plain PyTorch
// version nms3(fast_score(level, th)) of orb_slam2_ros2_tpu_torch/ops/fast.py
// on every pixel of every level, borders included:
//   * ring pixels wrap modulo the height and width of their own level, as the
//     plain version's torch.roll does, never into a neighbouring level or the
//     canvas padding;
//   * the NMS window skips out-of-level neighbours, as nms3's -inf padding
//     does;
//   * every ring difference is an f32 subtraction rounded once to bf16
//     (cvt.rn.bf16x2.f32, two pixels at a time); the 9-arc min/max, the
//     threshold and the suppression then run on those bf16 values two pixels
//     per instruction, which is exact (min/max select, and for a bf16 score
//     s > th in f32 exactly when s > th rounded down to bf16).  A bf16
//     subtraction (__hsub2) would round the exact difference once and differ
//     where the f32 rounding lands on a bf16 tie, so it is not used.
//
// What bounds it on an H100: operations.  Per pixel it reads one bf16 and
// writes one bf16, 11.6 MB for the 2,888,194 pixels of the two KITTI
// pyramids (3.4 us at 3.35 TB/s), against ~121 operations a pixel (16
// subtractions, 2 x 47 min/max for the best 9-arc of each sign, the
// threshold, the 3x3 suppression): 0.35 G operations, 5.2 us at the f32 peak
// of 67 T/s.  On the card the min/max (bf16x2 or f32), the f32 -> bf16
// packs, byte permutes, IMAD and IADD3 run at half the rate of FADD and
// LOP3 (16 lanes a clock per scheduler), so the ~45 such instructions a
// scored pixel of the arithmetic alone are what the design works against.
// Design:
//   * one launch: persistent blocks walk a flat list of every (image, level,
//     tile); a block finds a tile's level in the table's prefix of tile
//     counts;
//   * a 62x30 output tile per 256-thread block, scored with its 1 px NMS halo
//     as a 64x32 score tile: the halo costs 10% extra scores (33% for the
//     32x8 tile of the per-level design);
//   * the 70x38 input tile (score tile + ring radius) is staged in shared
//     memory as f32: an interior tile's input as 4-byte words, an edge
//     tile's through per-row and per-column wrap tables, each thread at
//     fixed coordinates of the tile, issuing all its loads before its first
//     store (most instructions here run at half rate, so the staging's
//     index arithmetic is kept out of the per-pixel loop);
//   * each thread scores one column of 8 pixels as 4 vertical pairs packed in
//     bf16x2, a warp's 32 columns reading 32 consecutive words of the tile;
//   * the best 9-arc of each sign takes 47 two-input min/max instead of the
//     doubling tree's 79 (arcs k and k+1, k even, share v[k+1..k+8], so the
//     better of the two is min(min(v[k+1..k+8]), max(v[k], v[k+9]))), which
//     the compiler emits as ~36 instructions, many of them three-input
//     (VHMNMX), for two pixels at once;
//   * the threshold and the suppression stay packed: scores go to shared
//     memory as bf16x2 row pairs, and each pair's 3x3 maximum is three
//     packed maxima and two byte permutes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int MAX_SEGS = 32;                   // (image, level) maps one launch takes
constexpr int OUT_W = 62, OUT_H = 30;          // output tile
constexpr int SW = OUT_W + 2, SH = OUT_H + 2;  // score tile: output + 1 px NMS halo
constexpr int RING = 3;                        // ring radius
constexpr int IW = SW + 2 * RING, IH = SH + 2 * RING;  // input tile
constexpr int THREADS = 256;
constexpr int RPT = SH / (THREADS / SW);       // score rows per thread (one column)
constexpr int PAIRS = RPT / 2;
constexpr int MIN_BLOCKS = 3;                  // resident blocks per SM (80 registers)
static_assert(THREADS % SW == 0 && SH % (THREADS / SW) == 0 && RPT % 2 == 0, "tiling");

// Mirror of the ctypes structure _LevelTable in ops/fast.py.
struct LevelTable {
  int n_segs;                    // (image, level) maps, level-major
  int row_stride;                // canvas columns
  int row_base[MAX_SEGS];        // canvas row of the map's row 0 (its column 0 is canvas column 0)
  int h[MAX_SEGS];
  int w[MAX_SEGS];
  int tiles_x[MAX_SEGS];         // output tiles across the map
  int tile_start[MAX_SEGS + 1];  // prefix of tile counts; [n_segs] is the number of tiles
  int out_off[MAX_SEGS];         // element offset of the map's [h, w] scores in out
};

typedef __nv_bfloat162 bf2;

__device__ __forceinline__ unsigned bits(bf2 v) { return *reinterpret_cast<unsigned*>(&v); }
__device__ __forceinline__ bf2 from_bits(unsigned u) { return *reinterpret_cast<bf2*>(&u); }

// Best 9-arc of the 16 ring differences v (two pixels per bf16x2): the max
// over k of min(v[k..k+8]), or with DARK the max over k of min(-v[k..k+8]),
// computed as -(min over k of max(v[k..k+8])).  Indices are modulo 16.  For
// even k, arcs k and k+1 share v[k+1..k+8] = 4-runs at odd starts k+1, k+5.
template <bool DARK>
__device__ __forceinline__ bf2 best_arc(const bf2 v[16]) {
  auto lo = [](bf2 a, bf2 b) { return DARK ? __hmax2(a, b) : __hmin2(a, b); };
  auto hi = [](bf2 a, bf2 b) { return DARK ? __hmin2(a, b) : __hmax2(a, b); };
  bf2 p[8], m4[8], x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = lo(v[2 * i + 1], v[(2 * i + 2) & 15]);  // v[j..j+1], j = 2i+1
#pragma unroll
  for (int i = 0; i < 8; ++i) m4[i] = lo(p[i], p[(i + 1) & 7]);             // v[j..j+3]
#pragma unroll
  for (int i = 0; i < 8; ++i)  // better of arcs 2i and 2i+1
    x[i] = lo(lo(m4[i], m4[(i + 2) & 7]), hi(v[2 * i], v[(2 * i + 9) & 15]));
  bf2 best = hi(hi(x[0], x[1]), x[2]);
  best = hi(best, hi(hi(x[3], x[4]), x[5]));
  best = hi(best, hi(x[6], x[7]));
  return DARK ? __hneg2(best) : best;
}

struct Tile {
  int s;       // table entry
  int sy, sx;  // score tile origin in the map
};

__device__ __forceinline__ Tile locate(const LevelTable& tab, int id) {
  int s = 0;
  while (s + 1 < tab.n_segs && tab.tile_start[s + 1] <= id) ++s;
  const int t = id - tab.tile_start[s];
  const int ty = t / tab.tiles_x[s];
  return Tile{s, ty * OUT_H - 1, (t - ty * tab.tiles_x[s]) * OUT_W - 1};
}

// Input tile staging.  A tile whose input lies inside its map, in a canvas of
// even row stride, is read as 4-byte words (two pixels; the input tile starts
// at an even column).  A tile at a map's edge, whose ring pixels wrap around
// the map, is read pixel by pixel.  Each thread starts all its loads before
// its first shared store.
constexpr int IWW = IW / 2;                  // words per input row
constexpr int WROWS = THREADS / IWW;         // input rows a pass of word loads covers
constexpr int WLOADS = (IH + WROWS - 1) / WROWS;
constexpr int PROWS = THREADS / IW;          // input rows a pass of pixel loads covers
constexpr int PLOADS = (IH + PROWS - 1) / PROWS;
static_assert(IW % 2 == 0 && OUT_W % 2 == 0, "word staging");

__device__ __forceinline__ bool by_words(const LevelTable& tab, const Tile& t) {
  return (tab.row_stride & 1) == 0 && t.sy >= RING && t.sy - RING + IH <= tab.h[t.s] &&
         t.sx >= RING && t.sx - RING + IW <= tab.w[t.s];
}

// v modulo n: one add or subtract for v in [-n, 2n), a division beyond that
// (maps smaller than the input tile)
__device__ __forceinline__ int wrap(int v, int n) {
  v += v < 0 ? n : 0;
  v -= v >= n ? n : 0;
  if (static_cast<unsigned>(v) >= static_cast<unsigned>(n)) {
    v %= n;
    v += v < 0 ? n : 0;
  }
  return v;
}

// Threads of the first WROWS * IWW read word column wc of input rows wr,
// wr + WROWS, ...; the others idle.
__device__ __forceinline__ void stage_words(const LevelTable& tab,
                                            const __nv_bfloat16* __restrict__ canvas,
                                            const Tile& t, float (*tile)[IW], int wr, int wc) {
  if (wr >= WROWS) return;
  const size_t stride = tab.row_stride / 2;
  const unsigned* src = reinterpret_cast<const unsigned*>(
                            canvas + (size_t)(tab.row_base[t.s] + t.sy - RING) * tab.row_stride +
                            (t.sx - RING)) + wr * stride + wc;
  unsigned w[WLOADS];
#pragma unroll
  for (int j = 0; j < WLOADS; ++j)
    if (wr + j * WROWS < IH) w[j] = __ldg(src + j * WROWS * stride);
#pragma unroll
  for (int j = 0; j < WLOADS; ++j)
    if (wr + j * WROWS < IH)
      *reinterpret_cast<float2*>(&tile[wr + j * WROWS][2 * wc]) =
          make_float2(__uint_as_float(w[j] << 16), __uint_as_float(w[j] & 0xFFFF0000u));
}

// An edge tile: each input row's wrapped canvas offset and each input
// column's wrapped column are computed once, into shared memory; threads of
// the first PROWS * IW then read column pc of input rows pr, pr + PROWS, ...
__device__ __forceinline__ void stage_pixels(const LevelTable& tab,
                                             const __nv_bfloat16* __restrict__ canvas,
                                             const Tile& t, float (*tile)[IW], int* row_off,
                                             int* col_at, int pr, int pc) {
  const int stride = tab.row_stride;
  if (threadIdx.x < IH)
    row_off[threadIdx.x] = (tab.row_base[t.s] + wrap(t.sy - RING + (int)threadIdx.x, tab.h[t.s])) * stride;
  else if (threadIdx.x < IH + IW)
    col_at[threadIdx.x - IH] = wrap(t.sx - RING + (int)threadIdx.x - IH, tab.w[t.s]);
  __syncthreads();
  if (pr >= PROWS) return;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(canvas) + col_at[pc];
  unsigned v[PLOADS];
#pragma unroll
  for (int j = 0; j < PLOADS; ++j)
    if (pr + j * PROWS < IH) v[j] = __ldg(src + row_off[pr + j * PROWS]);
#pragma unroll
  for (int j = 0; j < PLOADS; ++j)
    if (pr + j * PROWS < IH) tile[pr + j * PROWS][pc] = __uint_as_float(v[j] << 16);
}

template <bool NMS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fast_nms_kernel(const __nv_bfloat16* __restrict__ canvas, __nv_bfloat16* __restrict__ out,
                const __grid_constant__ LevelTable tab, unsigned short th_floor) {
  __shared__ float tile[IH][IW];
  __shared__ int row_off[IH], col_at[IW];  // an edge tile's wrapped rows and columns
  __shared__ bf2 sc[NMS ? SH / 2 : 1][SW];  // scores, row pairs, -inf outside the map

  // Bresenham ring of radius 3, clockwise from 12 o'clock (ops/fast.py CIRCLE_OFFSETS)
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const bf2 th = __bfloat162bfloat162(__ushort_as_bfloat16(th_floor));
  const unsigned neg_inf = 0xFF80u;
  const int n_tiles = tab.tile_start[tab.n_segs];
  const int c = threadIdx.x % SW;
  const int r0 = (threadIdx.x / SW) * RPT;
  const int wr = threadIdx.x / IWW, wc = threadIdx.x % IWW;  // word staging
  const int pr = threadIdx.x / IW, pc = threadIdx.x % IW;    // pixel staging

  // persistent blocks, each walking the tiles id, id + gridDim.x, ...
  for (int id = blockIdx.x; id < n_tiles; id += gridDim.x) {
    const Tile cur = locate(tab, id);
    __syncthreads();  // the previous tile is no longer read
    if (by_words(tab, cur))
      stage_words(tab, canvas, cur, tile, wr, wc);
    else
      stage_pixels(tab, canvas, cur, tile, row_off, col_at, pr, pc);
    __syncthreads();

    const int H = tab.h[cur.s], W = tab.w[cur.s];
    const int lx = cur.sx + c;
    bf2 sv[PAIRS];  // thresholded scores of rows (r0 + 2p, r0 + 2p + 1)
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int ra = r0 + 2 * p + RING, cc = c + RING;
      const float ca = tile[ra][cc], cb = tile[ra + 1][cc];
      bf2 d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        d[k] = __floats2bfloat162_rn(tile[ra + dy[k]][cc + dx[k]] - ca,
                                     tile[ra + 1 + dy[k]][cc + dx[k]] - cb);
      const bf2 s2 = __hmax2(best_arc<false>(d), best_arc<true>(d));
      // s > th in f32  <=>  s > th rounded down to bf16 (s is a bf16)
      sv[p] = from_bits(bits(s2) & __hgt2_mask(s2, th));
    }

    if (NMS) {
      const bool inner = cur.sy >= 0 && cur.sy + SH <= H && cur.sx >= 0 && cur.sx + SW <= W;
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        unsigned u = bits(sv[p]);
        if (!inner) {
          const int ly = cur.sy + r0 + 2 * p;
          const bool col = lx >= 0 && lx < W;
          if (!(col && ly >= 0 && ly < H)) u = (u & 0xFFFF0000u) | neg_inf;
          if (!(col && ly + 1 >= 0 && ly + 1 < H)) u = (u & 0x0000FFFFu) | (neg_inf << 16);
        }
        sc[r0 / 2 + p][c] = from_bits(u);
      }
      __syncthreads();
      // max over columns c-1..c+1 of row pairs r0/2 - 1 .. r0/2 + PAIRS; the
      // clamped pairs and columns at the tile's edge feed only halo pixels
      const int cl = max(c - 1, 0), cr = min(c + 1, SW - 1);
      bf2 h[PAIRS + 2];
#pragma unroll
      for (int j = 0; j < PAIRS + 2; ++j) {
        const int q = min(max(r0 / 2 - 1 + j, 0), SH / 2 - 1);
        h[j] = __hmax2(__hmax2(sc[q][cl], sc[q][cr]), sc[q][c]);
      }
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        // rows (2p-1, 2p) and (2p+1, 2p+2) beside the pair's own (2p, 2p+1)
        const bf2 below = from_bits(__byte_perm(bits(h[p]), bits(h[p + 1]), 0x5432));
        const bf2 above = from_bits(__byte_perm(bits(h[p + 1]), bits(h[p + 2]), 0x5432));
        const bf2 m = __hmax2(__hmax2(below, above), h[p + 1]);
        sv[p] = from_bits(bits(sv[p]) & __hge2_mask(sv[p], m));
      }
    }

    if (c >= 1 && c <= OUT_W && lx < W) {
      __nv_bfloat16* o = out + tab.out_off[cur.s] + lx;
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const int r = r0 + 2 * p, ly = cur.sy + r;
        if (r >= 1 && r <= OUT_H && ly < H) o[(size_t)ly * W] = __low2bfloat16(sv[p]);
        if (r + 1 <= OUT_H && ly + 1 < H) o[(size_t)(ly + 1) * W] = __high2bfloat16(sv[p]);
      }
    }
  }
}

template <bool NMS>
int launch(const void* canvas, void* out, const LevelTable& tab, unsigned short th_floor,
           cudaStream_t st) {
  static int grid_cap = 0;  // resident blocks on the card
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fast_nms_kernel<NMS>, THREADS, 0);
    grid_cap = sms * per_sm;
  }
  const int n_tiles = tab.tile_start[tab.n_segs];
  const int blocks = n_tiles < grid_cap ? n_tiles : grid_cap;
  if (blocks > 0)
    fast_nms_kernel<NMS><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(canvas), static_cast<__nv_bfloat16*>(out), tab, th_floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// canvas: bf16 rows of row_stride columns on the device; out: bf16, one
// [h, w] map per table entry at its out_off; table: a host LevelTable, copied
// into the launch.  Returns cudaGetLastError() (cudaErrorInvalidValue for a
// malformed table).
extern "C" int fast_nms_pyramid_bf16(const void* canvas, void* out, const void* table, float th,
                                     int nms, void* stream) {
  const LevelTable& tab = *static_cast<const LevelTable*>(table);
  if (tab.n_segs < 1 || tab.n_segs > MAX_SEGS) return static_cast<int>(cudaErrorInvalidValue);
  // th rounded down to a bf16: for a bf16 score s, s > th  <=>  s > th_floor
  unsigned u;
  memcpy(&u, &th, sizeof u);
  unsigned short th_floor = static_cast<unsigned short>(u >> 16);
  if ((u & 0xFFFFu) != 0 && (u >> 31) != 0) th_floor += 1;  // negative: away from zero
  auto st = static_cast<cudaStream_t>(stream);
  return nms ? launch<true>(canvas, out, tab, th_floor, st)
             : launch<false>(canvas, out, tab, th_floor, st);
}
