// Superpixel extent (find_super_pixel_boundary, clcode.cl:791-855) for
// Hopper (sm_90a): from each superpixel's clamped centre, walk the 8
// compass rays up to S - 1 steps and keep i - 1 for the last radius i whose
// pixel still carries the superpixel's label.
//
// Replaces the JAX package's superpixel_extent
// (cl_multiview_stereo_tpu/ops/superpixel.py:111, the windowed TPU form)
// and superpixel_extent_walk (:39), XLA functions, not Pallas.  The
// port's plain form (ops/superpixel.superpixel_extent_reference) makes
// (S - 1) x 8 gathers of the label map, each with about a dozen
// elementwise passes over the cells: about 670 launches a scene at
// 9 x 135 x 240 cells.
//
// Semantics, as the plain form's: each centre is truncated toward zero as
// the C cast does (cvt.rzi, as torch's .to(int64) on the card: NaN gives
// 0, out-of-range values saturate) and clamped as clamp_center does, in
// 64-bit integers that wrap as torch's do.  For each radius and each
// compass slot in _DIRS order (nw, w, sw, n, s, ne, e, se) the unclamped
// (px, py) is tested against the view, and only inside it is the label
// read (the plain form reads the clamped pixel and masks it; a view
// narrower than 2 S puts rays outside it even after the clamp).  The ray
// keeps the last matching radius, not the first miss.  The result is
// integer, so the kernel is bitwise the plain form.
//
// Bound: the bytes.  A cell reads 8 bytes of centre and writes 32; the
// label sectors its rays cross are about the whole map (75 MB at 9 x 1080
// x 1920).  A first form, one thread a cell, made 56 scattered 4-byte
// reads a thread, one 32-byte sector each: about 523 MB through L2.
// extent_kernel: a block takes a tile of 4 x 16 cells of one view, one
// thread a (cell, compass slot), a cell's 8 slots on 8 neighbouring lanes
// (its 8 int32 leave as one 32-byte store, a warp's 4 cells as 128
// contiguous bytes).  The tile's rays cross the same label sectors, about
// 50 x 146 labels at S = 8, so each sector comes from L2 into the SM's L1
// about once a tile and the tile's other reads of it hit there.  A form
// that first staged that box in shared memory (16-byte cp.async copies, a
// barrier, then the walk) was slower on the card: PERF.md has both.

#include <cuda_runtime.h>

namespace {

// cells of a tile, and a thread a (cell, compass slot)
constexpr int kTileY = 4, kTileX = 16;
constexpr int kThreads = 8 * kTileY * kTileX;
// the largest grid y and z
constexpr int kMaxGridYZ = 65535;

// compass slot k in the order nw, w, sw, n, s, ne, e, se as (dx, dy)
// (clcode.cl:826-851)
__device__ __forceinline__ int slot_dx(int k) { return k < 3 ? -1 : (k < 5 ? 0 : 1); }
__device__ __forceinline__ int slot_dy(int k) { return k < 3 ? k - 1 : (k < 5 ? 2 * k - 7 : k - 6); }

// a + b with two's-complement wrap, as torch's int64 add on the card
__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

// clamp_center (clcode.cl:809-819) on one axis of length n
__device__ __forceinline__ long long clamp_axis(long long c, long long n, long long s) {
  c = c < s ? s : c;
  return wrap_add(c, s) > n ? wrap_add(c, -s) : c;
}

// Blocks of (8 kTileX, kTileY) threads; block (bx, by, z) takes tile (bx,
// by) of views z, z + gridDim.z, ... (and tile rows by, by + gridDim.y, ...
// where the map has more tile rows than a grid's y reaches).
__global__ void __launch_bounds__(kThreads, 3) extent_kernel(
    const int* __restrict__ labels,     // (V, H, W)
    const float* __restrict__ centers,  // (V, Mh, Mw, 2), (x, y)
    int* __restrict__ out,              // (V, Mh, Mw, 8)
    int V, int H, int W, int Mh, int Mw, int S) {
  const int k = threadIdx.x & 7;
  const int mx = blockIdx.x * kTileX + (threadIdx.x >> 3);
  const int tiles_y = (Mh + kTileY - 1) / kTileY;
  const unsigned dx = slot_dx(k), dy = slot_dy(k);
  for (int v = blockIdx.z; v < V; v += gridDim.z) {
    const int* view = labels + (long long)v * H * W;
    for (int by = blockIdx.y; by < tiles_y; by += gridDim.y) {
      const int my = by * kTileY + threadIdx.y;
      if (my >= Mh || mx >= Mw) continue;
      const long long i = ((long long)v * Mh + my) * Mw + mx;
      const long long cx = clamp_axis((long long)__ldg(centers + 2 * i), W, S);
      const long long cy = clamp_axis((long long)__ldg(centers + 2 * i + 1), H, S);
      int ext = 0;
      // A cell whose centre lies more than S - 1 outside the view has no
      // ray pixel in it (a wrapped coordinate lies further out still).
      // Otherwise the ray's coordinates lie in [2 - 2 S, W + 2 S - 3], so
      // unsigned 32-bit ones (negative ones wrapped past W) give the same
      // bounds test.
      if (cx >= 1 - S && cx <= (long long)W + S - 2 && cy >= 1 - S && cy <= (long long)H + S - 2) {
        const int own = my * Mw + mx;
        unsigned px = (unsigned)cx, py = (unsigned)cy;
        for (int r = 1; r < S; ++r) {
          px += dx, py += dy;
          if (px < (unsigned)W && py < (unsigned)H && __ldg(view + (long long)py * W + px) == own) ext = r - 1;
        }
      }
      out[8 * i + k] = ext;
    }
  }
}

}  // namespace

// Blocks of the kernel that fit on one SM at once, into ``*blocks``, and
// the cells of a block's tile into ``*ty`` and ``*tx``; returns the CUDA
// error (0 on success).
extern "C" int extent_walk_blocks_per_sm(int* blocks, int* ty, int* tx) {
  *ty = kTileY, *tx = kTileX;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, extent_kernel, kThreads, 0);
}

// Plain C entry point, bound with ctypes.  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments it cannot take; it does not synchronise.
//
// The extent of V views of H x W labels with Mh x Mw superpixels of S
// pixels.
extern "C" int extent_walk_launch(const int* labels, const float* centers, int* out, int V, int H, int W, int Mh,
                                  int Mw, int S, void* stream) {
  if (V < 0 || H < 0 || W < 0 || Mh < 0 || Mw < 0 || S < 1 || S > 0x10000 ||
      (long long)V * Mh * Mw * 8 > 0x7fffffffLL || (long long)V * H * W > 0x7fffffffffffLL)
    return (int)cudaErrorInvalidValue;
  if ((long long)V * Mh * Mw == 0) return 0;
  const int tiles_y = (Mh + kTileY - 1) / kTileY;
  const dim3 grid((Mw + kTileX - 1) / kTileX, tiles_y < kMaxGridYZ ? tiles_y : kMaxGridYZ,
                  V < kMaxGridYZ ? V : kMaxGridYZ);
  extent_kernel<<<grid, dim3(8 * kTileX, kTileY), 0, static_cast<cudaStream_t>(stream)>>>(labels, centers, out, V,
                                                                                           H, W, Mh, Mw, S);
  return (int)cudaGetLastError();
}
