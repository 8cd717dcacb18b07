// PatchMatch consistency scores of all candidate moves of one sweep, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel cl_multiview_stereo_tpu/ops/pallas/consistency.py:
// _terms_kernel, together with the strip staging around it (_strip_gather,
// the escape fixup, _PAIR_CHUNK).  On the TPU those exist because Mosaic's
// lane gather cannot cross 128 lanes and narrow row gathers fall onto a
// scalar DMA path, so each (pair, cell, sample) row stages a 32-position
// strip and the kernel only emits per-sample terms.  Here each thread
// computes the whole score of compute_consistency (clcode.cl:1528-1631) for
// one cell and its moves, in the formula order of the port's
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
// Two rules for the samples that do not project into the table, picked per
// launch (kGather):
//   strips: a sample whose dip is not finite, or whose projection leaves
//     the image, adds 0 to every sum (the strips engine's rule for blown-up
//     planes);
//   gather: the gather engine's plain form, term for term.  A NaN shift
//     reads offset 0 (the form's nan_to_num), the in-image test gives
//     inb in {0, 1}, every sample reads ras at its clamped pixel and adds
//     inb*wv*exp(..), inb*wv, inb*(1 - wv), inb*exp(..) and inb as written,
//     so an out-of-image sample still adds 0*NaN = NaN where its dip is
//     NaN, as the form does.
// Both test the image on floats before any float-to-int conversion, so a
// finite but huge dip never reaches an undefined cast.
//
// Row window: ras may hold only the rows row_lo .. row_lo + rows - 1 of each
// table view (the row-sharded refinement's halo band); a projection outside
// them counts as outside the image, and the pixel (yp, xp) of view n is row
// n * rows * W + (yp - row_lo) * W + xp.  The table's views are indexed by
// the pair table, so it may hold more views than the launch scores (the
// view-sharded pipeline scores a block of its own views against every
// view's table).  The whole table is row_lo = 0, rows = H.
//
// Arithmetic: every product, sum and quotient is written with the _rn
// intrinsics and the library is built with --fmad=false; exp is the
// precise expf; subnormals are flushed to zero explicitly (ftz) at the
// points where the plain form calls refine._ftz, as the JAX reference's
// XLA arithmetic does.  cl_round is the plain form's
// x >= 0 ? floor(x + 0.5) : ceil(x - 0.5) in f32: half away from zero,
// never rint's half to even.  Each output's operations and their order do
// not depend on how the work is laid over threads, so a move scored alone
// gives the bits of its row of a batched call (a card test checks it).
//
// What bounds it on the card: the scattered 16-byte reads of ras (the
// rasterized input state, V*H*W rows; 299 MB at 9 x 1080p, beyond the
// 50 MB L2): 9 samples x the view's pairs per (move, cell), each in its
// own 32-byte sector, about 373 MB of sectors per move at the full size.
// The M moves of a cell read the same 9 sample pixels shifted by
// cl_round(dip*dv), which differs between moves by a pixel or two, so the
// sectors of one move are nearly all those of the others: the least the
// kernel can stream is one pass of them.  With one thread per (move, view,
// cell) and the move slowest in the grid, every cell finished move m
// before any started move m+1, and each of the 8 moves streamed those
// sectors from device memory again: 8 passes.
//
// The design: the grid runs over (view, tile of cells); the moves of one
// cell are scored by neighbouring lanes of one warp (lanes = M rounded up
// to a power of two, at most 8; lane l takes the moves l, l + lanes, ...).
// So one load instruction of a warp reads the same (pair, sample) for
// every move of a few cells: the moves' reads fall on the same sectors and
// are served as one, and the data is streamed once.  Each thread loads its
// cell's move-independent data (centre, colour, fl, the 9 sample positions)
// once; the pair table is staged once per block into shared memory; ras is
// read through the read-only path (__ldg of a float4).
//
// The kernel is then bound by latency, so occupancy decides: the sample
// positions (as floats, so that the bounds test and the index need no
// int-to-float conversions) and the 9 plane disparities of the move sit
// in a column of shared memory per thread, not in registers.  That keeps
// the kernel at about 40 registers and no spills, with 128-thread blocks.
// On an H100 80GB HBM3 at 700 W, at 9 x 1080p with 8 moves, this took
// 0.39 ms a launch; a thread scoring K = 2, 4 or 8 moves in a row (fewer
// lanes per cell, so the moves' reads spread over more instructions, and
// fewer threads) took 0.46, 0.80 and 1.79 ms.  Held in registers, the
// positions and disparities more than doubled the registers, cut the
// occupancy and the kernel took about twice as long.
//
// The price of the lane layout: a warp's load of d_c (and its store of
// out) spans 8 move planes of 4 cells, 16 bytes each, so it touches 8
// sectors where 32 cells of one plane would touch 4 (n_c: 16-24 against
// 12).  Those 47 MB of moves and scores are small next to the ~373 MB of
// ras sectors, and a neighbouring warp reads the other half of each sector.
//
// Left for later: half of every 32-byte sector read is wasted (one float4
// per sector, at scattered pixels), and reuse between the reference views
// that read one neighbour image is left to chance in L2.

#include <cuda_runtime.h>

namespace {

constexpr float kMargin = 0.01f;
constexpr float kFltMin = 1.17549435e-38f;  // smallest normal float32
constexpr int kSamples = 9;
constexpr int kWarp = 32;
constexpr int kMaxLanes = 8;  // lanes that share one cell
constexpr int kThreads = 128;

__device__ __forceinline__ float ftz(float x) { return fabsf(x) < kFltMin ? 0.0f : x; }

__device__ __forceinline__ float cl_round(float x) {
  return x >= 0.0f ? floorf(__fadd_rn(x, 0.5f)) : ceilf(__fadd_rn(x, -0.5f));
}

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

// The five per-pair sums of one move.
struct PairSums {
  float num, visib_sum, visible, visibility, occl_sum;
};

// Adds the terms of the sample at (sx, sy) (integral floats) for
// disparity dp to s.  Strips rule: nothing if dp is not finite or its
// projection leaves the image or the row window.  Gather rule: the plain
// form's terms, each weighted by the in-image flag.
template <bool kGather>
__device__ __forceinline__ void add_sample(PairSums& s, float sx, float sy, float dp,
                                           const float4* __restrict__ nb, float dvx, float dvy,
                                           int H, int W, int row_lo, int rows, float c0, float c1,
                                           float c2, float gamma, float alpha, float fuse,
                                           float bl) {
  if (!kGather && !isfinite(dp)) return;
  float rx = cl_round(__fmul_rn(dp, dvx));
  float ry = cl_round(__fmul_rn(__fmul_rn(bl, dp), dvy));
  if (kGather) {  // a NaN shift reads offset 0; +-inf leaves the image either way
    rx = isnan(rx) ? 0.0f : rx;
    ry = isnan(ry) ? 0.0f : ry;
  }
  // sx - rx and sy - ry: exact while |rx|, |ry| < 2**24, and beyond that
  // far outside the image either way
  const float xf = __fsub_rn(sx, rx), yf = __fsub_rn(sy, ry);
  const bool in = xf >= 0.0f && xf < (float)W && yf >= 0.0f && yf < (float)H &&
                  yf >= (float)row_lo && yf < (float)(row_lo + rows);
  float4 g;
  float inb = 1.0f;
  if (kGather) {
    // the plain form clamps after the float test, then truncates
    inb = in ? 1.0f : 0.0f;
    const int ix = (int)fminf(fmaxf(xf, 0.0f), (float)(W - 1));
    const int iy = (int)fminf(fmaxf(__fsub_rn(yf, (float)row_lo), 0.0f), (float)(rows - 1));
    g = __ldg(nb + (iy * W + ix));  // rows * W < 2**31, checked at launch
  } else {
    if (!in) return;
    g = __ldg(nb + (((int)yf - row_lo) * W + (int)xf));
  }
  const float diff = __fsub_rn(g.x, dp);
  const float wv = fabsf(diff) < fuse ? 1.0f : 0.0f;
  // inb * wv and inb * (1 - wv): wv and 1 - wv themselves under the strips rule
  const float iw = kGather ? __fmul_rn(inb, wv) : wv;
  const float io = kGather ? __fmul_rn(inb, __fsub_rn(1.0f, wv)) : __fsub_rn(1.0f, wv);
  s.visible = __fadd_rn(s.visible, __fmul_rn(iw, ftz(expf(__fmul_rn(__fmul_rn(-diff, diff), alpha)))));
  s.visib_sum = __fadd_rn(s.visib_sum, iw);
  s.occl_sum = __fadd_rn(s.occl_sum, io);
  const float cdiff = __fadd_rn(__fadd_rn(sq(__fsub_rn(g.y, c0)), sq(__fsub_rn(g.z, c1))),
                                sq(__fsub_rn(g.w, c2)));
  const float vis = ftz(expf(__fmul_rn(-cdiff, gamma)));
  s.visibility = __fadd_rn(s.visibility, kGather ? __fmul_rn(inb, vis) : vis);
  s.num = __fadd_rn(s.num, inb);
}

// A pair's contribution to the view's running sums.
__device__ __forceinline__ void end_pair(const PairSums& s, float half_fl1, float& cons,
                                         float& cnt) {
  float contrib = 0.0f;
  if (s.visib_sum > 0.0f) {
    const float vs = fmaxf(s.visib_sum, 1e-30f);
    contrib = ftz(__fmul_rn(__fmul_rn(__fdiv_rn(s.visib_sum, fmaxf(s.num, 1.0f)),
                                      __fdiv_rn(s.visibility, vs)),
                            __fdiv_rn(s.visible, vs)));
  }
  contrib = __fadd_rn(contrib, s.occl_sum > 0.0f ? half_fl1 : 0.0f);
  cons = __fadd_rn(cons, contrib);
  cnt = __fadd_rn(cnt, s.num > 0.0f ? 1.0f : 0.0f);
}

__device__ __forceinline__ float final_score(float cons, float cnt) {
  float cs = kMargin;
  if (cnt > 0.0f) {
    const float q = __fdiv_rn(cons, fmaxf(cnt, 1.0f));
    cs = q < kMargin ? kMargin : q;  // keeps a NaN, as torch.clamp does
  }
  return cs;
}

// Threads: (view, tile of 32/lanes cells, cell, lane), lane fastest; lane
// l of a cell scores the moves l, l + lanes, ...
// Shared memory: the pair table, then a column per thread of 9 sample x,
// 9 sample y and 9 dip, one row of kThreads words for each.
template <bool kGather>
__global__ void __launch_bounds__(kThreads) consistency_kernel(
    const float* __restrict__ center,   // (V, Mh, Mw, 2)
    const float* __restrict__ color,    // (V, Mh, Mw, 3)
    const int* __restrict__ samples,    // (V, Mh, 9, Mw, 2)
    const float* __restrict__ fl,       // (V, Mh, Mw, 2)
    const float4* __restrict__ ras,     // (views * rows * W,) [disp, L, a, b]
    const float* __restrict__ d_c,      // (M, V, Mh, Mw)
    const float* __restrict__ n_c,      // (M, V, Mh, Mw, 3)
    const int* __restrict__ pair_start, // (V + 1,) CSR over reference views
    const int* __restrict__ pair_view,  // (P,) table views
    const float* __restrict__ pair_dv,  // (P, 2) dvx, dvy
    float* __restrict__ out,            // (M, V, Mh, Mw)
    int M, int V, int Mh, int Mw, int H, int W, int row_lo, int rows, int P, int lanes,
    float gamma, float alpha, float fuse, float bl) {
  extern __shared__ int s_tab[];
  int* s_start = s_tab;               // V + 1
  int* s_view = s_tab + V + 1;        // P
  float* s_dv = reinterpret_cast<float*>(s_tab + V + 1 + P);  // 2P
  for (int i = threadIdx.x; i < V + 1; i += kThreads) s_start[i] = pair_start[i];
  for (int i = threadIdx.x; i < P; i += kThreads) s_view[i] = pair_view[i];
  for (int i = threadIdx.x; i < 2 * P; i += kThreads) s_dv[i] = pair_dv[i];
  __syncthreads();
  float* s_x = reinterpret_cast<float*>(s_tab + (V + 1 + 3 * P + 31) / 32 * 32) + threadIdx.x;
  float* s_y = s_x + kSamples * kThreads;
  float* s_dip = s_y + kSamples * kThreads;

  const int N = Mh * Mw;
  const int per_warp = kWarp / lanes;
  const int tiles = (N + per_warp - 1) / per_warp;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = (int)(idx % kWarp);
  const long long warp = idx / kWarp;
  const int cell = (int)(warp % tiles) * per_warp + lane / lanes;
  const int v = (int)(warp / tiles);
  if (v >= V || cell >= N) return;
  const int my = cell / Mw, mx = cell - my * Mw;

  // the cell's move-independent data, once
  const long long vc = (long long)v * N + cell;
  const float cx = center[2 * vc], cy = center[2 * vc + 1];
  const float c0 = color[3 * vc], c1 = color[3 * vc + 1], c2 = color[3 * vc + 2];
  const float half_fl1 = __fmul_rn(0.5f, fl[2 * vc + 1]);
  const int icx = (int)cx;  // C truncation, as the plain form's .to(int64)
  const int icy = (int)cy;
#pragma unroll
  for (int k = 0; k < kSamples; ++k) {
    const int* smp = samples + ((((long long)v * Mh + my) * kSamples + k) * Mw + mx) * 2;
    s_x[k * kThreads] = (float)(icx + smp[0]);
    s_y[k * kThreads] = (float)(icy + smp[1]);
  }

  const long long move_stride = (long long)V * N;
  const long long plane = (long long)rows * W;
  const int p_lo = s_start[v], p_hi = s_start[v + 1];
  for (int m = lane % lanes; m < M; m += lanes) {
    const long long o = m * move_stride + vc;
    const float d = d_c[o], nx = n_c[3 * o], ny = n_c[3 * o + 1], nz = n_c[3 * o + 2];
#pragma unroll
    for (int k = 0; k < kSamples; ++k) {
      const float numer = __fadd_rn(
          __fadd_rn(__fmul_rn(nx, __fsub_rn(cx, s_x[k * kThreads])),
                    __fmul_rn(ny, __fsub_rn(cy, s_y[k * kThreads]))),
          __fmul_rn(nz, d));
      s_dip[k * kThreads] = __fdiv_rn(numer, nz);
    }
    float cons = 0.0f, cnt = 0.0f;
    for (int p = p_lo; p < p_hi; ++p) {
      const float4* nb = ras + s_view[p] * plane;
      const float dvx = s_dv[2 * p], dvy = s_dv[2 * p + 1];
      PairSums s = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kSamples; ++k)
        add_sample<kGather>(s, s_x[k * kThreads], s_y[k * kThreads], s_dip[k * kThreads], nb,
                            dvx, dvy, H, W, row_lo, rows, c0, c1, c2, gamma, alpha, fuse, bl);
      end_pair(s, half_fl1, cons, cnt);
    }
    out[o] = final_score(cons, cnt);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  ``P`` is the number of pairs
// (the length of pair_view); ``H``, ``W`` the image size; ras holds the rows
// row_lo .. row_lo + rows - 1 of each table view; ``gather_rule`` picks the
// gather engine's rule (1) or the strips rule (0).  Launches on ``stream``
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for a pair table beyond 48 KB of shared memory, a table view of 2**31
// pixels or more, or an empty window; it does not synchronise.
extern "C" int consistency_launch(
    const float* center, const float* color, const int* samples,
    const float* fl, const float* ras, const float* d_c, const float* n_c,
    const int* pair_start, const int* pair_view, const float* pair_dv,
    float* out, int M, int V, int Mh, int Mw, int H, int W, int row_lo, int rows, int P,
    int gather_rule, float gamma, float alpha, float fuse, float bl_ratio, void* stream) {
  if ((long long)M * V * Mh * Mw == 0) return 0;
  int lanes = 1;
  while (lanes < M && lanes < kMaxLanes) lanes *= 2;
  const int per_warp = kWarp / lanes;
  const long long tiles = ((long long)Mh * Mw + per_warp - 1) / per_warp;
  const long long blocks = (V * tiles * kWarp + kThreads - 1) / kThreads;
  const size_t smem =
      sizeof(int) * ((size_t)(V + 1 + 3 * P + 31) / 32 * 32 + (size_t)3 * kSamples * kThreads);
  if (smem > 48 * 1024 || blocks > 0x7fffffffLL || rows < 1 || W < 1 ||
      (long long)rows * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float4* table = reinterpret_cast<const float4*>(ras);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gather_rule)
    consistency_kernel<true><<<(unsigned int)blocks, kThreads, smem, s>>>(
        center, color, samples, fl, table, d_c, n_c, pair_start, pair_view, pair_dv, out, M, V, Mh,
        Mw, H, W, row_lo, rows, P, lanes, gamma, alpha, fuse, bl_ratio);
  else
    consistency_kernel<false><<<(unsigned int)blocks, kThreads, smem, s>>>(
        center, color, samples, fl, table, d_c, n_c, pair_start, pair_view, pair_dv, out, M, V, Mh,
        Mw, H, W, row_lo, rows, P, lanes, gamma, alpha, fuse, bl_ratio);
  return (int)cudaGetLastError();
}
