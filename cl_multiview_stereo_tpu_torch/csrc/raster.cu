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
// Each pixel (v, yy, x) of the pixel rows row0 .. row0 + rows - 1 of each
// view reads its label l, then the owning cell's (cx, cy, d, nx, ny, nz)
// from the centre, disparity and normal maps (7 MB at 9 x 135 x 240 cells:
// they stay in L2), and computes
//   disp = ((nx * (cx - px) + ny * (cy - py)) + nz * d) / nz
// in the plain form's order, px = x and py = row0 + yy as float32, every
// step a _rn intrinsic and the divide IEEE.
//
// raster_kernel: a 2-D grid, a row of blocks a band of pixel rows
// (blockIdx.y the band, blockIdx.z the view, each looping past 65,535), a
// thread 4 neighbouring pixels of kRows rows: one 16-byte load of each
// row's labels, every load of its rows in flight before the first plane is
// read, and no per-pixel division.  A pixel whose label equals its left
// neighbour's in the thread reuses that cell's six values (a superpixel is
// ~8 pixels wide).  With `ras_color` (rasterize_table) it writes the table
// rows [disp, L, a, b], the colours in by three 16-byte loads a row, one
// row a thread; without it (rasterize_planes, fusion's map) the disparity
// alone, by one 16-byte store a row, 4 rows a thread.  Bound: bytes, 32 a
// pixel for the table and 8 for the map; the rows a thread keep the bytes
// in flight that hide the read latency.  A view width not a multiple of 4,
// or a label, colour or output base not 16-byte aligned, takes the same
// kernel at one pixel a thread, with the same arithmetic.
//
// A label outside [0, Mh * Mw) writes a NaN disparity; the plain form's
// gather raises there instead.  SLIC gives every pixel a label of its own
// view's map, so the main path never meets one.
//
// Arithmetic: --fmad=false, the _rn intrinsics, no fast math: bitwise the
// plain form on the card, whose elementwise passes round each step once.

#include <cuda_runtime.h>

namespace {

constexpr int kRasterThreads = 128;
// pixel rows a thread: the map's 8 bytes a pixel want 4 rows of loads in
// flight, the table's 32 one
constexpr int kMapRows = 4, kTableRows = 1;
constexpr int kGridMax = 65535;  // blocks a grid's y or z dimension

// The disparity of pixel (px, py) on the plane of cell c of the maps.
__device__ __forceinline__ float plane_disp(float cx, float cy, float d, float nx, float ny, float nz, float px,
                                            float py) {
  const float num = __fadd_rn(__fadd_rn(__fmul_rn(nx, __fsub_rn(cx, px)), __fmul_rn(ny, __fsub_rn(cy, py))),
                              __fmul_rn(nz, d));
  return __fdiv_rn(num, nz);
}

// kPix pixels a thread (4: one 16-byte load of their labels; 1 where a row
// or a base is not 16-byte aligned), kRows pixel rows a thread, all their
// loads in flight before the first plane is read.  kTable: the table row
// [disp, L, a, b] from ras_color, else the disparity alone.
template <int kPix, int kRows, bool kTable>
__global__ void __launch_bounds__(kRasterThreads) raster_kernel(
    const int* __restrict__ labels,       // (V, rows, W)
    const float* __restrict__ center,     // (V, Mh, Mw, 2)
    const float* __restrict__ state_d,    // (V, Mh, Mw)
    const float* __restrict__ state_n,    // (V, Mh, Mw, 3)
    const float* __restrict__ ras_color,  // (V * rows * W, 3) with kTable
    float* __restrict__ out,              // (V * rows * W, 4) with kTable, else (V, rows, W)
    int V, int cells, int rows, int W, int row0) {
  const int x0 = (blockIdx.x * kRasterThreads + threadIdx.x) * kPix;
  if (x0 >= W) return;
  for (int v = blockIdx.z; v < V; v += gridDim.z) {
    const float* __restrict__ cen = center + 2 * v * cells;
    const float* __restrict__ dv = state_d + v * cells;
    const float* __restrict__ nv = state_n + 3 * v * cells;
    for (int y0 = blockIdx.y * kRows; y0 < rows; y0 += gridDim.y * kRows) {
      int lbl[kRows][kPix];
      float col[kTable ? kRows : 1][kTable ? 3 * kPix : 1];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (y0 + k >= rows) continue;
        const int i = (v * rows + y0 + k) * W + x0;
        if constexpr (kPix == 4) {
          const int4 q = __ldg(reinterpret_cast<const int4*>(labels + i));
          lbl[k][0] = q.x;
          lbl[k][1] = q.y;
          lbl[k][2] = q.z;
          lbl[k][3] = q.w;
        } else {
          lbl[k][0] = __ldg(labels + i);
        }
        if constexpr (kTable) {
          if constexpr (kPix == 4) {
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              const float4 f = __ldg(reinterpret_cast<const float4*>(ras_color + 3 * i) + q);
              col[k][4 * q] = f.x;
              col[k][4 * q + 1] = f.y;
              col[k][4 * q + 2] = f.z;
              col[k][4 * q + 3] = f.w;
            }
          } else {
#pragma unroll
            for (int q = 0; q < 3; ++q) col[k][q] = __ldg(ras_color + 3 * i + q);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (y0 + k >= rows) continue;
        const int i = (v * rows + y0 + k) * W + x0;
        const float py = (float)(row0 + y0 + k);
        float disp[kPix];
        float cx = 0.0f, cy = 0.0f, d = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          const int l = lbl[k][p];
          const bool on = l >= 0 && l < cells;
          if (on && (p == 0 || l != lbl[k][p - 1])) {  // a new cell: its six values
            cx = __ldg(cen + 2 * l);
            cy = __ldg(cen + 2 * l + 1);
            d = __ldg(dv + l);
            nx = __ldg(nv + 3 * l);
            ny = __ldg(nv + 3 * l + 1);
            nz = __ldg(nv + 3 * l + 2);
          }
          disp[p] = on ? plane_disp(cx, cy, d, nx, ny, nz, (float)(x0 + p), py) : __int_as_float(0x7fffffff);
        }
        if constexpr (kTable) {
#pragma unroll
          for (int p = 0; p < kPix; ++p)
            reinterpret_cast<float4*>(out)[i + p] = make_float4(disp[p], col[k][3 * p], col[k][3 * p + 1],
                                                                col[k][3 * p + 2]);
        } else if constexpr (kPix == 4) {
          *reinterpret_cast<float4*>(out + i) = make_float4(disp[0], disp[1], disp[2], disp[3]);
        } else {
          out[i] = disp[0];
        }
      }
    }
  }
}

// Launches raster_kernel<kPix, kRows, kTable> over the rows of each view.
template <int kPix, int kRows, bool kTable>
void launch(const int* labels, const float* center, const float* state_d, const float* state_n,
            const float* ras_color, float* out, int V, int cells, int rows, int W, int row0, cudaStream_t st) {
  const int row_blocks = (rows + kRows - 1) / kRows;
  const dim3 grid((W / kPix + kRasterThreads - 1) / kRasterThreads, row_blocks < kGridMax ? row_blocks : kGridMax,
                  V < kGridMax ? V : kGridMax);
  raster_kernel<kPix, kRows, kTable><<<grid, kRasterThreads, 0, st>>>(labels, center, state_d, state_n, ras_color,
                                                                      out, V, cells, rows, W, row0);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quad = W % 4 == 0 && ((reinterpret_cast<size_t>(labels) | reinterpret_cast<size_t>(ras_color) |
                                    reinterpret_cast<size_t>(out)) & 15) == 0;
  if (ras_color != nullptr && quad)
    launch<4, kTableRows, true>(labels, center, state_d, state_n, ras_color, out, V, cells, rows, W, row0, st);
  else if (ras_color != nullptr)
    launch<1, kTableRows, true>(labels, center, state_d, state_n, ras_color, out, V, cells, rows, W, row0, st);
  else if (quad)
    launch<4, kMapRows, false>(labels, center, state_d, state_n, nullptr, out, V, cells, rows, W, row0, st);
  else
    launch<1, kMapRows, false>(labels, center, state_d, state_n, nullptr, out, V, cells, rows, W, row0, st);
  return (int)cudaGetLastError();
}
