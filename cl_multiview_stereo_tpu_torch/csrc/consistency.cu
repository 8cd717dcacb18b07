// PatchMatch consistency scores of all candidate moves of one sweep, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel cl_multiview_stereo_tpu/ops/pallas/consistency.py:
// _terms_kernel, together with the strip staging around it (_strip_gather,
// the escape fixup, _PAIR_CHUNK).  On the TPU those exist because Mosaic's
// lane gather cannot cross 128 lanes and narrow row gathers fall onto a
// scalar DMA path, so each (pair, cell, sample) row stages a 32-position
// strip and the kernel only emits per-sample terms.  Here one thread per
// (move, view, cell) computes the whole score of compute_consistency
// (clcode.cl:1528-1631), in the formula order of the port's
// refine.consistency_from_cache:
//
//   dip   = ((nx*(cx - sx) + ny*(cy - sy)) + nz*d) / nz  per sample
//   xp    = sx - (int)cl_round(dip*dvx)
//   yp    = sy - (int)cl_round((bl*dip)*dvy)              per pair
//   g     = ras[nbr, yp, xp]  (one float4: state disparity, L, a, b)
//   five per-pair sums over the 9 samples, in sample order; contrib;
//   + 0.5*fl1 if any sample is occluded; the per-view mean over the pairs
//   in subset order, floored at 0.01.
//
// A sample whose dip is not finite, or whose projection leaves the image,
// adds 0 to every sum (the strips engine's rule for blown-up planes).  The
// in-image test is made on the rounded float before any float-to-int
// conversion, so a finite but huge dip never reaches an undefined cast.
//
// Arithmetic: every product, sum and quotient is written with the _rn
// intrinsics and the library is built with --fmad=false; exp is the
// precise expf; subnormals are flushed to zero explicitly (ftz) at the
// points where the plain form calls refine._ftz, as the JAX reference's
// XLA arithmetic does.  cl_round is the plain form's
// x >= 0 ? floor(x + 0.5) : ceil(x - 0.5) in f32: half away from zero,
// never rint's half to even.
//
// What bounds it on the card: the scattered 16-byte reads of ras (the
// rasterized input state, V*H*W rows; 299 MB at 9 x 1080p, beyond the
// 50 MB L2): 9 samples x pairs per thread.  Neighbouring threads hold
// neighbouring cells of one view, so their projections fall near each
// other in the neighbour image and share sectors.

#include <cuda_runtime.h>

namespace {

constexpr float kMargin = 0.01f;
constexpr float kFltMin = 1.17549435e-38f;  // smallest normal float32
constexpr int kSamples = 9;

__device__ __forceinline__ float ftz(float x) { return fabsf(x) < kFltMin ? 0.0f : x; }

__device__ __forceinline__ float cl_round(float x) {
  return x >= 0.0f ? floorf(__fadd_rn(x, 0.5f)) : ceilf(__fadd_rn(x, -0.5f));
}

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

__global__ void consistency_kernel(
    const float* __restrict__ center,   // (V, Mh, Mw, 2)
    const float* __restrict__ color,    // (V, Mh, Mw, 3)
    const int* __restrict__ samples,    // (V, Mh, 9, Mw, 2)
    const float* __restrict__ fl,       // (V, Mh, Mw, 2)
    const float4* __restrict__ ras,     // (V * H * W,) [disp, L, a, b]
    const float* __restrict__ d_c,      // (M, V, Mh, Mw)
    const float* __restrict__ n_c,      // (M, V, Mh, Mw, 3)
    const int* __restrict__ pair_start, // (V + 1,) CSR over reference views
    const int* __restrict__ pair_view,  // (P,)
    const float* __restrict__ pair_dv,  // (P, 2) dvx, dvy
    float* __restrict__ out,            // (M, V, Mh, Mw)
    int M, int V, int Mh, int Mw, int H, int W,
    float gamma, float alpha, float fuse, float bl) {
  const long long total = (long long)M * V * Mh * Mw;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int mx = (int)(idx % Mw);
  long long t = idx / Mw;
  const int my = (int)(t % Mh);
  t /= Mh;
  const int v = (int)(t % V);

  const long long cell = ((long long)v * Mh + my) * Mw + mx;
  const float cx = center[2 * cell];
  const float cy = center[2 * cell + 1];
  const float d = d_c[idx];
  const float nx = n_c[3 * idx];
  const float ny = n_c[3 * idx + 1];
  const float nz = n_c[3 * idx + 2];
  const float c0 = color[3 * cell];
  const float c1 = color[3 * cell + 1];
  const float c2 = color[3 * cell + 2];
  const float half_fl1 = __fmul_rn(0.5f, fl[2 * cell + 1]);
  const int icx = (int)cx;  // C truncation, as the plain form's .to(int64)
  const int icy = (int)cy;

  // move-independent sample positions and the candidate plane's disparity
  int smp_x[kSamples], smp_y[kSamples];
  float dip[kSamples];
#pragma unroll
  for (int k = 0; k < kSamples; ++k) {
    const int* s = samples + ((((long long)v * Mh + my) * kSamples + k) * Mw + mx) * 2;
    smp_x[k] = icx + s[0];
    smp_y[k] = icy + s[1];
    const float numer = __fadd_rn(
        __fadd_rn(__fmul_rn(nx, __fsub_rn(cx, (float)smp_x[k])),
                  __fmul_rn(ny, __fsub_rn(cy, (float)smp_y[k]))),
        __fmul_rn(nz, d));
    dip[k] = __fdiv_rn(numer, nz);
  }

  const long long plane = (long long)H * W;
  float cons = 0.0f, cnt = 0.0f;
  for (int p = pair_start[v]; p < pair_start[v + 1]; ++p) {
    const float4* nb = ras + (long long)pair_view[p] * plane;
    const float dvx = pair_dv[2 * p];
    const float dvy = pair_dv[2 * p + 1];
    float num = 0.0f, visib_sum = 0.0f, visible = 0.0f, visibility = 0.0f, occl_sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kSamples; ++k) {
      const float dp = dip[k];
      if (!isfinite(dp)) continue;
      const float rx = cl_round(__fmul_rn(dp, dvx));
      const float ry = cl_round(__fmul_rn(__fmul_rn(bl, dp), dvy));
      // 0 <= sx - rx < W and 0 <= sy - ry < H, exact on integral floats
      if (!(rx <= (float)smp_x[k] && rx > (float)(smp_x[k] - W) &&
            ry <= (float)smp_y[k] && ry > (float)(smp_y[k] - H)))
        continue;
      const int xp = smp_x[k] - (int)rx;
      const int yp = smp_y[k] - (int)ry;
      const float4 g = nb[(long long)yp * W + xp];
      const float diff = __fsub_rn(g.x, dp);
      const float wv = fabsf(diff) < fuse ? 1.0f : 0.0f;
      visible = __fadd_rn(visible, __fmul_rn(wv, ftz(expf(__fmul_rn(__fmul_rn(-diff, diff), alpha)))));
      visib_sum = __fadd_rn(visib_sum, wv);
      occl_sum = __fadd_rn(occl_sum, __fsub_rn(1.0f, wv));
      const float cdiff = __fadd_rn(__fadd_rn(sq(__fsub_rn(g.y, c0)), sq(__fsub_rn(g.z, c1))),
                                    sq(__fsub_rn(g.w, c2)));
      visibility = __fadd_rn(visibility, ftz(expf(__fmul_rn(-cdiff, gamma))));
      num = __fadd_rn(num, 1.0f);
    }
    float contrib = 0.0f;
    if (visib_sum > 0.0f) {
      const float vs = fmaxf(visib_sum, 1e-30f);
      contrib = ftz(__fmul_rn(__fmul_rn(__fdiv_rn(visib_sum, fmaxf(num, 1.0f)),
                                        __fdiv_rn(visibility, vs)),
                              __fdiv_rn(visible, vs)));
    }
    contrib = __fadd_rn(contrib, occl_sum > 0.0f ? half_fl1 : 0.0f);
    cons = __fadd_rn(cons, contrib);
    cnt = __fadd_rn(cnt, num > 0.0f ? 1.0f : 0.0f);
  }
  float cs = kMargin;
  if (cnt > 0.0f) {
    const float q = __fdiv_rn(cons, fmaxf(cnt, 1.0f));
    cs = q < kMargin ? kMargin : q;  // keeps a NaN, as torch.clamp does
  }
  out[idx] = cs;
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int consistency_launch(
    const float* center, const float* color, const int* samples,
    const float* fl, const float* ras, const float* d_c, const float* n_c,
    const int* pair_start, const int* pair_view, const float* pair_dv,
    float* out, int M, int V, int Mh, int Mw, int H, int W, float gamma,
    float alpha, float fuse, float bl_ratio, void* stream) {
  const long long total = (long long)M * V * Mh * Mw;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  consistency_kernel<<<(unsigned int)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      center, color, samples, fl, reinterpret_cast<const float4*>(ras), d_c,
      n_c, pair_start, pair_view, pair_dv, out, M, V, Mh, Mw, H, W, gamma,
      alpha, fuse, bl_ratio);
  return (int)cudaGetLastError();
}
