// Fusion's cross-check for Hopper (sm_90a): the occlusion-aware inverse
// warp (project_to_reference_inv, clcode.cl:1995-2034) and the stability
// vote (remove_view_inconsistency, clcode.cl:2037-2101) of ops/fusion.py.
//
// Replaces the JAX package's project_to_reference_inv
// (cl_multiview_stereo_tpu/ops/fusion.py:150) and remove_view_inconsistency
// (:186), XLA functions, not Pallas.  The port's plain forms
// (ops/fusion.project_to_reference_inv_reference and
// remove_view_inconsistency_reference) loop over the views in Python, each
// probe a dozen whole-tensor passes with int64 index tensors: V probes for
// the warp, V x V lookups and V x V agreement terms for the vote, thousands
// of eager launches, each a pass over a (V, H, W) tensor.
//
// Both take a thread a (reference view r, pixel): a block a run of 128
// pixels of one row of one reference view (the warp: of kWarpRows rows), so
// no thread divides its index, a warp's loads of the maps at its own pixels
// are one 128-byte line, and view i's place on the camera grid, (i % aw,
// i / aw), is stepped along with i.
//
// fuse_warp: from r's own disparity m, the probe chain over the source
// views i in index order (i = r skipped, as the plain form's mask skips
// it), each probe shifted by the evolving maximum:
//   xp = x - cl_round(m * dx),  yp = y - cl_round((bl * m) * dy)
// with (dx, dy) the camera-grid delta r - i, and m takes the probed value
// where it lies in the view and m < it.  Each probe waits on the last (its
// address depends on m): a chain of V - 1 dependent loads, so a thread runs
// the chains of kWarpRows rows side by side, their loads in flight
// together.  Bound: the bytes (the map read once, the warped maps written
// once), far below what the chain's latency and its 50-odd instructions a
// probe take.
//
// fuse_vote: candidate i is the warped map of view i at the pixel, the same
// for every r; candidates run in view order, and a candidate is taken when
// d != 0, its stability >= 0 and (best == 0 or best < d).  A candidate that
// d != 0 or the last clause already refuses is skipped before its
// stability is computed: the stability cannot change the outcome.  Its
// stability is
//   vote 1: for each view j with proj[j] != 0: -1 if |proj[j] - d| > fuse,
//           else +1 (NaN compares false: +1);
//   vote 2: for each view j, the unwarped map j at
//           (x - cl_round(d * (jx - rx)), y - cl_round((bl * d) * (jy - ry)))
//           where that lies in the view: -1 if |map - d| > fuse, +1 if
//           |map - d| < fuse, 0 on equality or NaN.
// The votes are integers, so the sum is exact in any order (the plain form
// adds them in float32, where every partial sum is a small integer), and
// only its sign matters: vote 2 stops as soon as the lookups left cannot
// change it (stability - left >= 0, or stability + left < 0).  Bound: the
// operations of the candidates and lookups this run needs, the bytes near
// them: the two maps read once, the output written once.  Divergence
// seems to hold it back: a warp's 32 pixels look at different candidates
// and stop their lookups at different views, and the warp issues the
// union.  At 9 x 1080 x 1920 on the slice's refined disparity the vote
// looks at 83 M of 168 M (candidate, output) pairs and makes 349 M
// lookups, 47 % of theirs, yet running every lookup of those candidates
// took only a fifth more time (3.70 against 3.07 ms on an NVIDIA H100 80GB
// HBM3 at 700 W).
//
// A first form, a thread a flat index (divided by the shape), the grid's
// width divided in its loops and every lookup run, took 0.58 ms (warp) and
// 4.91 ms (vote) at 9 x 1080 x 1920 on an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md has the steps from it to these forms.
//
// Both follow the plain form's rounding step by step: --fmad=false, the
// _rn intrinsics, OpenCL round() (half away from zero: for x >= 0
// floor(x + 0.5), for x < 0 ceil(x - 0.5) = -floor(|x| + 0.5) as the
// rounding of x - 0.5 is symmetric, NaN for NaN; a zero result may carry
// x's sign, and the difference from the pixel's coordinate, never -0,
// erases it), and _probe's rule: a NaN coordinate reads offset 0, the
// bounds are tested on the float, and only a coordinate in the view is
// converted (the plain form clamps first; in the view the clamp changes
// nothing).  Every comparison is false on NaN, as torch's, so NaN lands
// where the plain form puts it: the kernels are bitwise the plain forms on
// the card.  Each output depends only on its own pixel's inputs, so a view
// range gives the bits of the whole launch's views.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;    // pixels of a row a block
constexpr int kMaxGridY = 65535;  // rows a grid's y dimension holds
constexpr int kWarpRows = 2;      // fuse_warp: rows a thread

// OpenCL round(): half away from zero, as ops/fusion.cl_round.
__device__ __forceinline__ float cl_round(float x) {
  return copysignf(floorf(__fadd_rn(fabsf(x), 0.5f)), x);
}

// ops/fusion._probe's rule, in three steps: a NaN coordinate reads 0; the
// bounds are tested on the float; only a coordinate in the H x W view is
// converted, to its offset in the view.
__device__ __forceinline__ float nan_to_zero(float v) { return isnan(v) ? 0.0f : v; }

__device__ __forceinline__ bool in_view(float xf, float yf, int H, int W) {
  return xf >= 0.0f && yf >= 0.0f && xf < (float)W && yf < (float)H;
}

__device__ __forceinline__ long long offset(float xf, float yf, int W) { return (long long)(int)yf * W + (int)xf; }

// Grid (row blocks of kThreads pixels, runs of kWarpRows rows, reference
// views); a run past the grid's y dimension is taken by the block
// gridDim.y runs above it.
__global__ void __launch_bounds__(kThreads) fuse_warp_kernel(
    const float* __restrict__ disp,  // (V, H, W)
    float* __restrict__ out,         // (nv, H, W)
    int V, int H, int W, int v0, int aw, float bl) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W) return;
  const long long hw = (long long)H * W;
  const int r = v0 + (int)blockIdx.z;
  const int rx = r % aw, ry = r / aw;
  const float px = (float)x;
  for (int y0 = kWarpRows * blockIdx.y; y0 < H; y0 += kWarpRows * gridDim.y) {
    const int rows = H - y0 < kWarpRows ? H - y0 : kWarpRows;
    const long long p = (long long)y0 * W + x;
    const float py = (float)y0;
    float m[kWarpRows];
#pragma unroll
    for (int k = 0; k < kWarpRows; ++k) m[k] = k < rows ? __ldg(disp + r * hw + p + k * W) : 0.0f;
    int ix = 0, iy = 0;
#pragma unroll 1
    for (int i = 0; i < V; ++i) {
      if (i != r) {
        const float dx = (float)(rx - ix), dy = (float)(ry - iy);
        bool in[kWarpRows];
        float val[kWarpRows];
#pragma unroll
        for (int k = 0; k < kWarpRows; ++k) {
          const float xp = nan_to_zero(__fsub_rn(px, cl_round(__fmul_rn(m[k], dx))));
          const float yp = nan_to_zero(__fsub_rn(py + (float)k, cl_round(__fmul_rn(__fmul_rn(bl, m[k]), dy))));
          in[k] = k < rows && in_view(xp, yp, H, W);
          val[k] = in[k] ? __ldg(disp + i * hw + offset(xp, yp, W)) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kWarpRows; ++k)
          if (in[k] && m[k] < val[k]) m[k] = val[k];
      }
      if (++ix == aw) ix = 0, ++iy;
    }
#pragma unroll
    for (int k = 0; k < kWarpRows; ++k)
      if (k < rows) out[blockIdx.z * hw + p + k * W] = m[k];
  }
}

// Grid (row blocks of kThreads pixels, rows, reference views).  Vote 2
// stops as soon as the sign of the stability is settled: with `left`
// lookups to go, each adding -1, 0 or +1, stability - left >= 0 takes the
// candidate and stability + left < 0 refuses it whatever they give.
__global__ void __launch_bounds__(kThreads) fuse_vote_kernel(
    const float* __restrict__ proj,  // (V, H, W) warped maps
    const float* __restrict__ disp,  // (V, H, W) unwarped maps
    float* __restrict__ out,         // (nv, H, W)
    int V, int H, int W, int v0, int aw, float bl, float fuse) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W) return;
  const long long hw = (long long)H * W;
  const int r = v0 + (int)blockIdx.z;
  const float rx = (float)(r % aw), ry = (float)(r / aw);
  const float px = (float)x;
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    const long long p = (long long)y * W + x;
    const float py = (float)y;
    float best = 0.0f;
#pragma unroll 1
    for (int i = 0; i < V; ++i) {
      const float d = __ldg(proj + i * hw + p);
      if (!(d != 0.0f && (best == 0.0f || best < d))) continue;  // refused whatever its stability
      int stability = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {  // vote 1: the warped maps at this pixel
        const float dc = __ldg(proj + j * hw + p);
        if (dc != 0.0f) stability += fabsf(__fsub_rn(dc, d)) > fuse ? -1 : 1;
      }
      const float bld = __fmul_rn(bl, d);
      int jx = 0, jy = 0;
#pragma unroll 1
      for (int j = 0, left = V; left > 0 && stability - left < 0 && stability + left >= 0; ++j, --left) {
        // vote 2: lookups in the unwarped maps
        const float xj = nan_to_zero(__fsub_rn(px, cl_round(__fmul_rn(d, __fsub_rn((float)jx, rx)))));
        const float yj = nan_to_zero(__fsub_rn(py, cl_round(__fmul_rn(bld, __fsub_rn((float)jy, ry)))));
        if (in_view(xj, yj, H, W)) {
          const float diff = fabsf(__fsub_rn(__ldg(disp + j * hw + offset(xj, yj, W)), d));
          stability += (diff > fuse ? -1 : 0) + (diff < fuse ? 1 : 0);
        }
        if (++jx == aw) jx = 0, ++jy;
      }
      if (stability >= 0) best = d;
    }
    out[blockIdx.z * hw + p] = best;
  }
}

// The shapes a launch takes: a view range inside V views on a grid of
// aw columns, no more views than a grid's z dimension holds.
bool bad_shape(int V, int H, int W, int v0, int nv, int aw) {
  return V < 0 || H < 0 || W < 0 || aw < 1 || v0 < 0 || nv < 0 || (long long)v0 + nv > V || nv > 65535;
}

// the grid of a launch over nv views of H rows, ``rows`` a thread
dim3 grid_of(int H, int W, int nv, int rows) {
  const int y = (H + rows - 1) / rows;
  return dim3((unsigned int)((W + kThreads - 1) / kThreads), (unsigned int)(y < kMaxGridY ? y : kMaxGridY),
              (unsigned int)nv);
}

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on ``stream``,
// does not synchronise and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes it does not take.

// out (nv, H, W): reference views v0 .. v0 + nv - 1 of disp (V, H, W)
// warped over every other view; aw cameras a row, bl the baseline ratio.
extern "C" int fuse_warp_launch(const float* disp, float* out, int V, int H, int W, int v0, int nv, int aw,
                                float bl, void* stream) {
  if (bad_shape(V, H, W, v0, nv, aw)) return (int)cudaErrorInvalidValue;
  if ((long long)nv * H * W == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  fuse_warp_kernel<<<grid_of(H, W, nv, kWarpRows), kThreads, 0, st>>>(disp, out, V, H, W, v0, aw, bl);
  return (int)cudaGetLastError();
}

// out (nv, H, W): the stability vote for reference views v0 .. v0 + nv - 1
// over proj (V, H, W), the warped maps, and disp (V, H, W), the unwarped
// ones; fuse the vote's threshold.
extern "C" int fuse_vote_launch(const float* proj, const float* disp, float* out, int V, int H, int W, int v0,
                                int nv, int aw, float bl, float fuse, void* stream) {
  if (bad_shape(V, H, W, v0, nv, aw)) return (int)cudaErrorInvalidValue;
  if ((long long)nv * H * W == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  fuse_vote_kernel<<<grid_of(H, W, nv, 1), kThreads, 0, st>>>(proj, disp, out, V, H, W, v0, aw, bl, fuse);
  return (int)cudaGetLastError();
}
