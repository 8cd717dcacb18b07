// Superpixel depth-init cost volume for Hopper (sm_90a).
//
// Replaces the TPU kernel cl_multiview_stereo_tpu/ops/cost_volume.py:
// _win_extract_kernel, together with the aligned block-pair gather around
// it (ops/pallas/consistency.py:_strip_gather) and the dense shift-plane
// sweep that superpixel_cost_volume_strips uses for the diagonal deltas.
// On the TPU those exist because Mosaic's lane gather cannot cross 128
// lanes and partial-row gathers fall onto a scalar DMA path.  Here each
// thread reads the Lab values it needs straight from device memory:
//
//   out[v, d, my, mx] = min over valid deltas g of
//                       sum over 25 samples (i outer, j inner) of
//                       ok ? |dL| + |da| + |db| : 30
//
// and 1e6 where no delta is valid.  A delta g = (gx, gy) is valid where the
// neighbour camera (v's grid position + g) lies inside the camera array.
// The reference sample is at (trunc(cx + i*step_x), trunc(cy + j*step_y));
// the projected read is at (yr - ceil(bl*d*gy), xr - ceil(d*gx)), clamped
// to the image (the JAX module's edge padding); ``ok`` is the exact f32
// test  -1 < xr - d*gx < W  and  -1 < yr - bl*d*gy < H  on an in-image
// reference sample.
//
// Arithmetic: every product and sum is written with __fmul_rn/__fadd_rn
// and the library is built with --fmad=false, so no FMA contraction moves
// a truncated coordinate or a validity test off the JAX result.  Samples
// are summed one at a time from 0 in the JAX order, channels L, a, b.
//
// What bounds it on the card: reads, not arithmetic.  Each (cell, d) does
// 8 deltas x 25 samples of two 12-byte Lab reads at scattered addresses
// (about 2 G sample terms at 9 x 1080p x 31 hypotheses); the Lab images
// (224 MB at that size) do not fit the 50 MB L2, but the threads of one
// block share (v, d, cell row), so their reads fall in a few image rows
// and hit L1/L2.  The simple design keeps it that way: one thread per
// output, mx fastest so that stores coalesce into the (V, D, Mh, Mw)
// layout, all loops inside the thread.  Shared-memory staging of the
// row bands is later work.

#include <cuda_runtime.h>

namespace {

constexpr float kOobPenalty = 30.0f;
constexpr float kBig = 1.0e6f;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void cost_volume_kernel(
    const float* __restrict__ lab,      // (V, H, W, 3)
    const float* __restrict__ centers,  // (V, Mh, Mw, 2) (x, y)
    const float* __restrict__ step,     // (V, Mh, Mw, 2) (step_x, step_y)
    const float* __restrict__ disp,     // (D,)
    float* __restrict__ out,            // (V, D, Mh, Mw)
    int V, int H, int W, int Mh, int Mw, int D,
    int array_width, int neib_hor, int neib_ver, float bl_ratio) {
  const long long total = (long long)V * D * Mh * Mw;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;

  const int mx = (int)(idx % Mw);
  long long t = idx / Mw;
  const int my = (int)(t % Mh);
  t /= Mh;
  const int d = (int)(t % D);
  const int v = (int)(t / D);

  const long long cell = ((long long)v * Mh + my) * Mw + mx;
  const float cx = centers[2 * cell];
  const float cy = centers[2 * cell + 1];
  const float sx = step[2 * cell];
  const float sy = step[2 * cell + 1];
  const float dl = disp[d];
  const float bl_d = __fmul_rn(bl_ratio, dl);

  const int array_height = V / array_width;
  const int zx = v % array_width;
  const int zy = v / array_width;
  const float* ref_img = lab + (long long)v * H * W * 3;

  float best = kBig;
  for (int gx = -neib_hor; gx <= neib_hor; ++gx) {
    for (int gy = -neib_ver; gy <= neib_ver; ++gy) {
      if (gx == 0 && gy == 0) continue;
      if (zx + gx < 0 || zx + gx >= array_width || zy + gy < 0 ||
          zy + gy >= array_height)
        continue;
      const int nv = v + gy * array_width + gx;
      const float* nb_img = lab + (long long)nv * H * W * 3;
      const float cxs = __fmul_rn(dl, (float)gx);    // d * gx
      const float cys = __fmul_rn(bl_d, (float)gy);  // (bl * d) * gy
      const int shx = (int)ceilf(cxs);
      const int shy = (int)ceilf(cys);

      float acc = 0.0f;
      for (int i = -2; i <= 2; ++i) {
        const int xr = (int)__fadd_rn(cx, __fmul_rn((float)i, sx));
        const float px = __fadd_rn((float)xr, -cxs);
        const bool x_ok = xr >= 0 && xr < W && px > -1.0f && px < (float)W;
        for (int j = -2; j <= 2; ++j) {
          const int yr = (int)__fadd_rn(cy, __fmul_rn((float)j, sy));
          const float py = __fadd_rn((float)yr, -cys);
          const bool ok = x_ok && yr >= 0 && yr < H && py > -1.0f && py < (float)H;
          float term = kOobPenalty;
          if (ok) {
            const float* r = ref_img + ((long long)yr * W + xr) * 3;
            const int xp = clampi(xr - shx, 0, W - 1);
            const int yp = clampi(yr - shy, 0, H - 1);
            const float* q = nb_img + ((long long)yp * W + xp) * 3;
            term = __fadd_rn(__fadd_rn(fabsf(__fadd_rn(r[0], -q[0])),
                                       fabsf(__fadd_rn(r[1], -q[1]))),
                             fabsf(__fadd_rn(r[2], -q[2])));
          }
          acc = __fadd_rn(acc, term);
        }
      }
      best = fminf(best, acc);
    }
  }
  out[idx] = best;
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int cost_volume_launch(
    const float* lab, const float* centers, const float* step,
    const float* disp, float* out, int V, int H, int W, int Mh, int Mw,
    int D, int array_width, int neib_hor, int neib_ver, float bl_ratio,
    void* stream) {
  const long long total = (long long)V * D * Mh * Mw;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  cost_volume_kernel<<<(unsigned int)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      lab, centers, step, disp, out, V, H, W, Mh, Mw, D, array_width,
      neib_hor, neib_ver, bl_ratio);
  return (int)cudaGetLastError();
}
