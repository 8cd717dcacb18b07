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
// Row window (the row-tiled sweep of parallel/spatial.py), a second
// instantiation of the kernel.  ``lab`` then holds only the rows band0 ..
// band0 + Hb - 1 of each view, and the kernel writes the output rows
// out0 .. out0 + Ho - 1 into (V, Ho, W).  Every row test and clamp above
// stays on the global row y and the global H; the launch moves the base
// pointers (lab back by band0 rows, the outputs back by out0), so the
// kernel indexes by global row.  The blocks keep their tiles of the whole
// image: the grid covers rows 0 .. out0 + Ho - 1, the blocks above out0
// return at once, and a block writes only its rows in the window.  (A
// grid that started at out0 put the offset in every row index, and the
// 128-register cap then spilled 276 bytes.)  The caller (ops/sweep.py)
// hands a band that holds every row the blocks stage: the rows the
// written outputs read, [max(0, out0 - R - max sy), min(H - 1, out0 + Ho
// - 1 + R - min sy)], and around them, out to the whole tiles, rows that
// only unwritten outputs read.  The whole image keeps the first
// instantiation, the kernel as it was before the window existed.
//
// What bounds it.  The function's bound is its f32 operations (17 per
// (pair, hypothesis, pixel) at radius 2); its bytes are one read of the
// images.  The kernel is far from both: it is bound by the instructions
// it issues per (pair, hypothesis, pixel) and by their latency at the
// occupancy its registers allow.  The neighbour reloads are not what
// bounds it: taking them out alone (a shared-memory slab, the SAD tile and
// both box passes still in shared memory behind two barriers per
// (hypothesis, pair), 124 registers, two blocks per SM) made the kernel
// slower than its first form (PERF.md §6).
//
// The design.  The host cuts the ladder, in its own order, into chunks of
// at most kChunk hypotheses whose shifts spread by at most kSpare rows and
// columns for every pair, and gives each (pair, chunk) the slab's origin
// (the largest sy and sx of the chunk) and extent (ops/sweep.py
// chunk_tables).  One block owns a tile of one reference view, kTileH
// rows by kWarpsX * (32 - 2R) columns.  For each (chunk, pair) it stages
// the neighbour slab once into shared memory, channel-planar, each entry
// read at its clamped image coordinate; every read of the hypothesis loop,
// nb[clamp(y - sy), clamp(x - sx)], is then the plain slab entry
// ((y - sy) - row0, (x - sx) - col0): no clamp and no global load there.
// A thread owns one halo column and kRows output rows.  It keeps its
// reference column in registers for the whole call, takes its SAD column
// and the vertical sums in registers, and the horizontal sums from warp
// shuffles in ascending order (up(R) ... up(1), self, down(1) ...
// down(R)); the 2R edge lanes of a warp compute halo columns only, and
// columns outside the image hold 0.  The only barriers are the slab's,
// two per (chunk, pair).  The chunk's running minimum over pairs stays in
// registers, m[kChunk][kRows], and after the chunk's last pair the WTA
// runs over the chunk in ascending hypothesis order, carrying (best,
// bestd) across chunks.  128 registers, no spills, two blocks per SM.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsX = 2;  // warps of a block side by side
constexpr int kWarpsY = 4;  // and stacked
constexpr int kThreads = 32 * kWarpsX * kWarpsY;
constexpr int kRows = 4;  // output rows of a thread
constexpr int kMaxR = 4;
constexpr int kChunk = 8;   // hypotheses a chunk holds at most (ops/sweep.py CHUNK)
constexpr int kSpare = 16;  // slab rows and columns beyond the halo (ops/sweep.py SPARE)
constexpr int kTileH = kWarpsY * kRows;
constexpr int kSadRows = kRows + 2 * kMaxR;
constexpr int kPitch = 32 * kWarpsX + kSpare;  // the halo is at most 32 * kWarpsX wide
constexpr int kSlabH = kTileH + 2 * kMaxR + kSpare;
constexpr int kSlabN = kSlabH * kPitch;  // a channel plane of the slab
constexpr float kOobPenalty = 30.0f;
constexpr float kBig = 1.0e6f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <bool kWindow>
__global__ void __launch_bounds__(kThreads, 2) sweep_kernel(
    const float* __restrict__ lab,          // (V, Hb, W, 3), back by band0 rows
    const int* __restrict__ pair_start,     // (V + 1,) CSR over reference views
    const int* __restrict__ pair_view,      // (P,) neighbour view of each pair
    const int* __restrict__ shifts,         // (P, D, 4) sy, sx, loy, lox
    const float* __restrict__ ladder,       // (D,)
    const int* __restrict__ chunk_start,    // (C + 1,) first hypothesis of each chunk
    const int* __restrict__ slab_box,       // (P, C, 4) max sy, max sx, min sy, min sx
    float* __restrict__ disp,               // (V, Ho, W), back by out0 rows
    float* __restrict__ cost,               // (V, Ho, W), back by out0 rows
    int H, int W, int D, int R, int C, int Hb, int out0, int Ho) {
  __shared__ float slab_s[3 * kSlabN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int step = 32 - 2 * R;  // output columns of a warp
  const int tw = kWarpsX * step;
  const int v = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  if (kWindow && y0 + kTileH <= out0) return;  // the whole block above the window
  const int x0 = blockIdx.x * tw;
  const int c = (warp % kWarpsX) * step + lane;  // halo column, from x0 - R
  const int r0 = (warp / kWarpsX) * kRows;       // first SAD row, from y0 - R
  const int x = x0 - R + c;
  const int ybase = y0 - R + r0;
  const bool x_in = x >= 0 && x < W;
  const int n_sad = kRows + 2 * R;
  const long long plane = (long long)(kWindow ? Hb : H) * W;  // a view in lab
  const float* ref_img = lab + (long long)v * plane * 3;

  float ref[kSadRows][3];
#pragma unroll
  for (int j = 0; j < kSadRows; ++j) {
    const int y = ybase + j;
    const bool in = j < n_sad && x_in && y >= 0 && y < H;
    const float* q = ref_img + ((long long)(in ? y : 0) * W + (in ? x : 0)) * 3;
    ref[j][0] = in ? q[0] : 0.0f;
    ref[j][1] = in ? q[1] : 0.0f;
    ref[j][2] = in ? q[2] : 0.0f;
  }

  float best[kRows], bestd[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    best[i] = kBig;
    bestd[i] = 0.0f;
  }
  const int p0 = pair_start[v];
  const int p1 = pair_start[v + 1];

  for (int ci = 0; ci < C; ++ci) {
    const int d0 = chunk_start[ci];
    const int d1 = chunk_start[ci + 1];
    float m[kChunk][kRows];
#pragma unroll
    for (int jd = 0; jd < kChunk; ++jd)
#pragma unroll
      for (int i = 0; i < kRows; ++i) m[jd][i] = kBig;

    for (int p = p0; p < p1; ++p) {
      const int* box = slab_box + ((long long)p * C + ci) * 4;
      const int my = box[0], mx = box[1];
      const int rows = kTileH + 2 * R + my - box[2];
      const int cols = tw + 2 * R + mx - box[3];
      const float* nb_img = lab + (long long)pair_view[p] * plane * 3;
      __syncthreads();  // every warp is done with the previous slab
      // the slab: entry (i, j) = nb[clamp(row0 + i), clamp(col0 + j)]; the
      // entries e = tid + k * kThreads of this thread step by
      // divmod(kThreads, cols)
      {
        const int row0 = y0 - R - my, col0 = x0 - R - mx;
        const int i_step = kThreads / cols, j_step = kThreads % cols;
        int i = tid / cols, j = tid % cols;
        for (int e = tid; e < rows * cols; e += kThreads) {
          const float* q = nb_img + ((long long)clampi(row0 + i, 0, H - 1) * W +
                                     clampi(col0 + j, 0, W - 1)) * 3;
          const int s = i * kPitch + j;
          slab_s[s] = q[0];
          slab_s[kSlabN + s] = q[1];
          slab_s[2 * kSlabN + s] = q[2];
          i += i_step;
          j += j_step;
          if (j >= cols) {
            j -= cols;
            ++i;
          }
        }
      }
      __syncthreads();

#pragma unroll
      for (int jd = 0; jd < kChunk; ++jd) {
        const int d = d0 + jd;
        if (d < d1) {
          const int* sh = shifts + ((long long)p * D + d) * 4;
          const int sy = sh[0], sx = sh[1], loy = sh[2], lox = sh[3];
          const bool col_win = x >= lox && x <= W - 1 + sx;
          // slab entry of SAD row 0 of this column
          const float* sl = slab_s + (r0 + my - sy) * kPitch + (c + mx - sx);
          float sad[kSadRows];
#pragma unroll
          for (int j = 0; j < kSadRows; ++j) {
            const int y = ybase + j;
            float s = 0.0f;  // outside the reference image: adds 0
            if (j < n_sad && x_in && y >= 0 && y < H) {
              if (col_win && y >= loy && y <= H - 1 + sy) {
                const float* q = sl + j * kPitch;
                s = __fadd_rn(__fadd_rn(fabsf(__fsub_rn(ref[j][0], q[0])),
                                        fabsf(__fsub_rn(ref[j][1], q[kSlabN]))),
                              fabsf(__fsub_rn(ref[j][2], q[2 * kSlabN])));
              } else {
                s = kOobPenalty;
              }
            }
            sad[j] = s;
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            // vertical window, from its first term
            float vs = sad[i];
#pragma unroll
            for (int j = 1; j <= 2 * kMaxR; ++j)
              if (j <= 2 * R) vs = __fadd_rn(vs, sad[i + j]);
            // horizontal window from the neighbouring lanes, ascending;
            // lanes below R or from 32 - R up read themselves and are not
            // written out
            float acc = vs;
            if (R > 0) {
              acc = __shfl_up_sync(kFull, vs, R);
#pragma unroll
              for (int k = kMaxR - 1; k >= 1; --k)
                if (k < R) acc = __fadd_rn(acc, __shfl_up_sync(kFull, vs, k));
              acc = __fadd_rn(acc, vs);
#pragma unroll
              for (int k = 1; k <= kMaxR; ++k)
                if (k <= R) acc = __fadd_rn(acc, __shfl_down_sync(kFull, vs, k));
            }
            m[jd][i] = fminf(m[jd][i], acc);
          }
        }
      }
    }

    // the chunk's WTA, in ascending hypothesis order
#pragma unroll
    for (int jd = 0; jd < kChunk; ++jd) {
      const int d = d0 + jd;
      if (d < d1) {
        const float dl = ladder[d];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (m[jd][i] < best[i]) {
            best[i] = m[jd][i];
            bestd[i] = dl;
          }
        }
      }
    }
  }

  if (lane >= R && lane < 32 - R && x < W) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int y = y0 + r0 + i;
      if (kWindow ? y >= out0 && y < out0 + Ho : y < H) {
        const long long o = kWindow ? ((long long)v * Ho + y) * W + x
                                    : (long long)v * plane + (long long)y * W + x;
        disp[o] = bestd[i];
        cost[o] = best[i];
      }
    }
  }
}

}  // namespace

// Blocks of the kernel that fit on one SM at once, the fewer of its two
// instantiations, into ``*blocks``; returns the CUDA error (0 on success).
extern "C" int sweep_blocks_per_sm(int* blocks) {
  int whole = 0, window = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&whole, sweep_kernel<false>, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&window, sweep_kernel<true>, kThreads, 0);
  *blocks = whole < window ? whole : window;
  return (int)e;
}

// Plain C entry point, bound with ctypes.  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success); it does not synchronise.
// R (the box radius) must lie in [0, 4]; the chunk tables come from
// ops/sweep.py chunk_tables, built for kChunk and kSpare.  ``lab`` holds
// the rows band0 .. band0 + Hb - 1 of an image H rows high and the output
// the rows out0 .. out0 + Ho - 1 (the row window above); the whole image
// is band0 = out0 = 0, Hb = Ho = H.
extern "C" int sweep_launch(
    const float* lab, const int* pair_start, const int* pair_view,
    const int* shifts, const float* ladder, const int* chunk_start, const int* slab_box,
    float* disp, float* cost, int V, int H, int W, int D, int R, int C,
    int band0, int Hb, int out0, int Ho, void* stream) {
  if (R < 0 || R > kMaxR) return (int)cudaErrorInvalidValue;
  if (band0 < 0 || Hb < 1 || band0 + Hb > H || out0 < 0 || Ho < 0 || out0 + Ho > H)
    return (int)cudaErrorInvalidValue;
  if ((long long)V * Ho * W == 0) return 0;
  const int tw = kWarpsX * (32 - 2 * R);
  const dim3 grid((W + tw - 1) / tw, (out0 + Ho + kTileH - 1) / kTileH, V);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band0 == 0 && Hb == H && out0 == 0 && Ho == H) {
    sweep_kernel<false><<<grid, kThreads, 0, s>>>(
        lab, pair_start, pair_view, shifts, ladder, chunk_start, slab_box, disp, cost, H, W, D,
        R, C, H, 0, H);
  } else {
    // base pointers moved so that the kernel indexes lab and the outputs
    // by global row (no row above band0 or out0 is read or written)
    sweep_kernel<true><<<grid, kThreads, 0, s>>>(
        lab - (long long)band0 * W * 3, pair_start, pair_view, shifts, ladder, chunk_start,
        slab_box, disp - (long long)out0 * W, cost - (long long)out0 * W, H, W, D, R, C, Hb,
        out0, Ho);
  }
  return (int)cudaGetLastError();
}
