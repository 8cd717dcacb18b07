// Plane rasterization (spixl_to_image, clcode.cl:1906-1931) for Hopper
// (sm_90a): each pixel takes the plane of the superpixel that owns it.
//
// Replaces the JAX package's _rasterize_flat
// (cl_multiview_stereo_tpu/ops/refine.py:187) and rasterize_planes_gather
// (cl_multiview_stereo_tpu/ops/fusion.py:125), XLA functions, not Pallas.
// The port's plain forms (ops/refine.rasterize_table_reference and
// ops/fusion.rasterize_planes_reference) concatenate a (V, Mh, Mw, 6) cell
// pack, gather it to a (V, rows, W, 6) pixel copy, run five elementwise
// passes over it and concatenate the per-pixel colour: about 1.2 GB of
// traffic at 9 x 1080 x 1920 for a function that needs 32 bytes a pixel.
//
// raster_kernel: one thread a pixel (v, yy, x) of the pixel rows row0 ..
// row0 + rows - 1 of each view.  It reads the pixel's label l, then the
// owning cell's (cx, cy, d, nx, ny, nz) from the centre, disparity and
// normal maps (7 MB at 9 x 135 x 240 cells: they stay in L2), and computes
//   disp = ((nx * (cx - px) + ny * (cy - py)) + nz * d) / nz
// in the plain form's order, px = x and py = row0 + yy as float32, every
// step a _rn intrinsic and the divide IEEE.  With `ras_color` it writes
// the table row [disp, L, a, b] (one float4 a pixel; rasterize_table),
// without it the disparity alone (rasterize_planes).
//
// A label outside [0, Mh * Mw) writes a NaN disparity; the plain form's
// gather raises there instead.  SLIC gives every pixel a label of its own
// view's map, so the main path never meets one.
//
// Arithmetic: --fmad=false, the _rn intrinsics, no fast math: bitwise the
// plain form on the card, whose elementwise passes round each step once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) raster_kernel(
    const int* __restrict__ labels,       // (V, rows, W)
    const float* __restrict__ center,     // (V, Mh, Mw, 2)
    const float* __restrict__ state_d,    // (V, Mh, Mw)
    const float* __restrict__ state_n,    // (V, Mh, Mw, 3)
    const float* __restrict__ ras_color,  // (V * rows * W, 3), or null
    float* __restrict__ out,              // (V * rows * W, 4) with ras_color, else (V * rows * W)
    int V, int cells, int rows, int W, int row0) {
  const int n = V * rows * W;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int x = i % W, vr = i / W;
    const int y = row0 + vr % rows, v = vr / rows;
    const int lbl = __ldg(labels + i);
    float disp = __int_as_float(0x7fffffff);
    if (lbl >= 0 && lbl < cells) {
      const int c = v * cells + lbl;
      const float cx = __ldg(center + 2 * c), cy = __ldg(center + 2 * c + 1), d = __ldg(state_d + c);
      const float nx = __ldg(state_n + 3 * c), ny = __ldg(state_n + 3 * c + 1), nz = __ldg(state_n + 3 * c + 2);
      const float num = __fadd_rn(__fadd_rn(__fmul_rn(nx, __fsub_rn(cx, (float)x)),
                                            __fmul_rn(ny, __fsub_rn(cy, (float)y))),
                                  __fmul_rn(nz, d));
      disp = __fdiv_rn(num, nz);
    }
    if (ras_color != nullptr) {
      reinterpret_cast<float4*>(out)[i] =
          make_float4(disp, __ldg(ras_color + 3 * i), __ldg(ras_color + 3 * i + 1), __ldg(ras_color + 3 * i + 2));
    } else {
      out[i] = disp;
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments it cannot take; it does not synchronise.
//
// The disparity of the pixel rows row0 .. row0 + rows - 1 of V views of W
// columns, from maps of `cells` cells a view; with `ras_color` the table
// rows [disp, L, a, b] (`out` 16-byte aligned), else the disparity alone.
extern "C" int raster_planes_launch(const int* labels, const float* center, const float* state_d,
                                    const float* state_n, const float* ras_color, float* out, int V, int cells,
                                    int rows, int W, int row0, void* stream) {
  if (V < 0 || cells < 0 || rows < 0 || W < 0 || row0 < 0 || (long long)row0 + rows > 0x1000000LL ||
      W > 0x1000000 || 4LL * V * rows * W > 0x7fffffffLL || (long long)V * cells * 3 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int n = V * rows * W;
  if (n == 0) return 0;
  raster_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      labels, center, state_d, state_n, ras_color, out, V, cells, rows, W, row0);
  return (int)cudaGetLastError();
}
