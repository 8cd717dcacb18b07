// Dense per-pixel plane sweep with winner-take-all, for Hopper (sm_90a).
//
// Replaces the TPU kernel cl_multiview_stereo_tpu/ops/pallas/sweep.py:
// _sweep_kernel.  It computes, for every reference view v and pixel (y, x),
//
//   cost_d(y, x) = min over the pairs (v, n) of
//                  box_{2r+1}( sad_{n,d} )(y, x)
//   sad_{n,d}(y, x) = valid ? (|dL| + |da|) + |db| : 30
//                     (0 where (y, x) lies outside the reference image)
//   disp, cost      = strict-< scan of cost_d over d ascending, from
//                     (0, 1e6)
//
// The neighbour is read at (clamp(y - sy), clamp(x - sx)) and a sample is
// valid iff loy <= y <= H-1+sy and lox <= x <= W-1+sx.  The integer
// tables (sy, sx, loy, lox) per (pair, hypothesis) are ceil/floor of the
// double-precision shifts, computed on the host exactly as the JAX form
// computes them.  The box sum adds rows first, then columns, each from
// its first term in ascending offset; min over pairs and the WTA are
// exact.  Adds are written with __fadd_rn and the library is built with
// --fmad=false, so the result equals the plain PyTorch twin (and the JAX
// forms) bitwise.
//
// The TPU kernel pads the images into 8-aligned channel-planar slabs and
// keeps a (D, tile, W) cost volume in VMEM; none of that is needed here.
// One block owns a 16 x 64 pixel tile of one reference view and keeps its
// reference halo in shared memory for the whole sweep.  For each
// (hypothesis, pair) it fills a SAD halo tile from the neighbour image
// (reads of neighbouring threads fall on neighbouring pixels, mostly L2
// hits: the shifted rows of one tile span a few image rows), takes the
// row sums and then the column sums out of shared memory, and folds the
// box into a per-thread running min over pairs and the WTA in registers.
//
// What bounds it on the card: the SAD fill, about 1.7 halo entries per
// output pixel per (hypothesis, pair), each two 12-byte Lab reads and a
// dozen instructions; 9 x 1080p x 31 hypotheses x 4.4 pairs is about
// 5 G entries.  Reusing the SAD tile across hypotheses (the shifts move
// by one pixel per step) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 64;
constexpr int kTileH = 16;
constexpr int kThreads = 256;
constexpr int kMaxR = 4;
constexpr int kHaloW = kTileW + 2 * kMaxR;
constexpr int kHaloH = kTileH + 2 * kMaxR;
constexpr int kPix = kTileW * kTileH / kThreads;                    // 4
constexpr int kSadPer = (kHaloH * kHaloW + kThreads - 1) / kThreads;  // 7
constexpr int kRowPer = (kTileH * kHaloW + kThreads - 1) / kThreads;  // 5
constexpr float kOobPenalty = 30.0f;
constexpr float kBig = 1.0e6f;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kThreads) sweep_kernel(
    const float* __restrict__ lab,        // (V, H, W, 3)
    const int* __restrict__ pair_start,   // (V + 1,) CSR over reference views
    const int* __restrict__ pair_view,    // (P,) neighbour view of each pair
    const int* __restrict__ shifts,       // (P, D, 4) sy, sx, loy, lox
    const float* __restrict__ ladder,     // (D,)
    float* __restrict__ disp,             // (V, H, W)
    float* __restrict__ cost,             // (V, H, W)
    int H, int W, int D, int R) {
  __shared__ float ref_s[3][kHaloH * kHaloW];
  __shared__ float sad_s[kHaloH * kHaloW];
  __shared__ float row_s[kTileH * kHaloW];

  const int v = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int hw = kTileW + 2 * R;  // halo width in use
  const int n_halo = (kTileH + 2 * R) * hw;
  const int n_row = kTileH * hw;
  const int tid = threadIdx.x;
  const long long plane = (long long)H * W;
  const float* ref_img = lab + (long long)v * plane * 3;

  // halo entries of this thread (fixed for the whole sweep); -1 = unused
  int e_y[kSadPer], e_x[kSadPer], e_i[kSadPer];
#pragma unroll
  for (int k = 0; k < kSadPer; ++k) {
    const int e = tid + k * kThreads;
    e_i[k] = e < n_halo ? e : -1;
    e_y[k] = y0 - R + e / hw;
    e_x[k] = x0 - R + e % hw;
  }
  for (int e = tid; e < n_halo; e += kThreads) {
    const int y = y0 - R + e / hw;
    const int x = x0 - R + e % hw;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const float* p = ref_img + ((long long)(in ? y : 0) * W + (in ? x : 0)) * 3;
    ref_s[0][e] = in ? p[0] : 0.0f;
    ref_s[1][e] = in ? p[1] : 0.0f;
    ref_s[2][e] = in ? p[2] : 0.0f;
  }

  float best[kPix], bestd[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    best[k] = kBig;
    bestd[k] = 0.0f;
  }
  const int p0 = pair_start[v];
  const int p1 = pair_start[v + 1];
  __syncthreads();

  for (int d = 0; d < D; ++d) {
    float m[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) m[k] = kBig;

    for (int p = p0; p < p1; ++p) {
      const float* nb_img = lab + (long long)pair_view[p] * plane * 3;
      const int* sh = shifts + ((long long)p * D + d) * 4;
      const int sy = sh[0], sx = sh[1], loy = sh[2], lox = sh[3];

      // 1. SAD halo tile
#pragma unroll
      for (int k = 0; k < kSadPer; ++k) {
        const int e = e_i[k];
        if (e < 0) continue;
        const int y = e_y[k], x = e_x[k];
        float s = 0.0f;  // outside the reference image: adds 0
        if (y >= 0 && y < H && x >= 0 && x < W) {
          if (y >= loy && y <= H - 1 + sy && x >= lox && x <= W - 1 + sx) {
            const float* q =
                nb_img + ((long long)clampi(y - sy, 0, H - 1) * W + clampi(x - sx, 0, W - 1)) * 3;
            s = __fadd_rn(__fadd_rn(fabsf(__fsub_rn(ref_s[0][e], q[0])),
                                    fabsf(__fsub_rn(ref_s[1][e], q[1]))),
                          fabsf(__fsub_rn(ref_s[2][e], q[2])));
          } else {
            s = kOobPenalty;
          }
        }
        sad_s[e] = s;
      }
      __syncthreads();

      // 2. row sums (vertical window), from the first term
#pragma unroll
      for (int k = 0; k < kRowPer; ++k) {
        const int e = tid + k * kThreads;
        if (e < n_row) {
          float acc = sad_s[e];
          for (int j = 1; j <= 2 * R; ++j) acc = __fadd_rn(acc, sad_s[e + j * hw]);
          row_s[e] = acc;
        }
      }
      __syncthreads();

      // 3. column sums (horizontal window) and the min over pairs
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const int q = tid + k * kThreads;
        const int base = (q / kTileW) * hw + q % kTileW;
        float acc = row_s[base];
        for (int j = 1; j <= 2 * R; ++j) acc = __fadd_rn(acc, row_s[base + j]);
        m[k] = fminf(m[k], acc);
      }
      // no barrier here: the next pair writes sad_s only, and row_s is
      // rewritten after the barrier that follows that fill
    }

    const float dl = ladder[d];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (m[k] < best[k]) {
        best[k] = m[k];
        bestd[k] = dl;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int q = tid + k * kThreads;
    const int y = y0 + q / kTileW;
    const int x = x0 + q % kTileW;
    if (y < H && x < W) {
      const long long o = (long long)v * plane + (long long)y * W + x;
      disp[o] = bestd[k];
      cost[o] = best[k];
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success); it does not synchronise.
// R (the box radius) must lie in [0, 4].
extern "C" int sweep_launch(
    const float* lab, const int* pair_start, const int* pair_view,
    const int* shifts, const float* ladder, float* disp, float* cost,
    int V, int H, int W, int D, int R, void* stream) {
  if (R < 0 || R > kMaxR) return (int)cudaErrorInvalidValue;
  if ((long long)V * H * W == 0) return 0;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, V);
  sweep_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lab, pair_start, pair_view, shifts, ladder, disp, cost, H, W, D, R);
  return (int)cudaGetLastError();
}
