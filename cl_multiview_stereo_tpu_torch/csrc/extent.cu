// Superpixel extent (find_super_pixel_boundary, clcode.cl:791-855) for
// Hopper (sm_90a): from each superpixel's clamped centre, walk the 8
// compass rays up to S - 1 steps and keep i - 1 for the last radius i whose
// pixel still carries the superpixel's label.
//
// Replaces the JAX package's superpixel_extent
// (cl_multiview_stereo_tpu/ops/superpixel.py:182, the windowed TPU form)
// and superpixel_extent_walk (:110), XLA functions, not Pallas.  The
// port's plain form (ops/superpixel.superpixel_extent_reference) makes
// (S - 1) x 8 gathers of the label map, each with about a dozen
// elementwise passes over the cells: about 670 launches a scene at
// 9 x 135 x 240 cells.
//
// extent_kernel: one thread a cell (v, my, mx).  It truncates the centre
// toward zero as the C cast does (cvt.rzi, as torch's .to(int64) on the
// card: NaN gives 0, out-of-range values saturate) and clamps it as
// clamp_center does, in 64-bit integers that wrap as torch's do.  For
// each radius and each compass slot in _DIRS order (nw, w, sw, n, s, ne,
// e, se) it tests the unclamped (px, py) against the view, and only
// inside it reads the label (the plain form reads the clamped pixel and
// masks it; a view narrower than 2 S puts rays outside it even after the
// clamp).  It writes the 8 int32 of a cell as two 16-byte stores.
//
// Bound: the bytes.  A cell reads 8 bytes of centre, at most 56 labels on
// its rays and writes 32 bytes; the rays of neighbouring cells cross each
// other's 8-pixel rows, so the label sectors read are about the whole map
// (75 MB at 9 x 1080 x 1920).  The 56 reads of a thread are scattered,
// one sector each; neighbouring threads' rays share sectors in L2.  The
// result is integer, so the kernel is bitwise the plain form.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// compass slot k in the order nw, w, sw, n, s, ne, e, se as (dx, dy)
// (clcode.cl:826-851); constants once the slot loop is unrolled
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

__global__ void __launch_bounds__(kThreads) extent_kernel(
    const int* __restrict__ labels,     // (V, H, W)
    const float* __restrict__ centers,  // (V, Mh, Mw, 2), (x, y)
    int* __restrict__ out,              // (V, Mh, Mw, 8)
    int V, int H, int W, int cells, int S) {
  const int n = V * cells;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int own = i % cells, v = i / cells;
    const long long cx = clamp_axis((long long)__ldg(centers + 2 * i), W, S);
    const long long cy = clamp_axis((long long)__ldg(centers + 2 * i + 1), H, S);
    const int* view = labels + (long long)v * H * W;
    int ext[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int r = 1; r < S; ++r) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const long long px = wrap_add(cx, (long long)r * slot_dx(k));
        const long long py = wrap_add(cy, (long long)r * slot_dy(k));
        if (px >= 0 && py >= 0 && px < W && py < H && __ldg(view + py * W + px) == own) ext[k] = r - 1;
      }
    }
    int4* dst = reinterpret_cast<int4*>(out) + 2 * (long long)i;
    dst[0] = make_int4(ext[0], ext[1], ext[2], ext[3]);
    dst[1] = make_int4(ext[4], ext[5], ext[6], ext[7]);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments it cannot take; it does not synchronise.
//
// The extent of V views of H x W labels with Mh x Mw superpixels of S
// pixels; `out` 16-byte aligned.
extern "C" int extent_walk_launch(const int* labels, const float* centers, int* out, int V, int H, int W,
                                  int Mh, int Mw, int S, void* stream) {
  if (V < 0 || H < 0 || W < 0 || Mh < 0 || Mw < 0 || S < 1 || S > 0x10000 ||
      (long long)V * Mh * Mw * 8 > 0x7fffffffLL || (long long)V * H * W > 0x7fffffffffffLL)
    return (int)cudaErrorInvalidValue;
  const int n = V * Mh * Mw;
  if (n == 0) return 0;
  extent_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      labels, centers, out, V, H, W, Mh * Mw, S);
  return (int)cudaGetLastError();
}
