// SLIC superpixel segmentation's three per-pixel loops, for Hopper (sm_90a):
// the assignment, the cluster update and the connectivity vote of
// ops/slic.py.
//
// Replaces cl_multiview_stereo_tpu/ops/slic.py: find_center_association
// (:102), update_cluster_centers (:178) and suppress_local_labels (:340).
// Those are XLA, not Pallas: the JAX package shaped them for the TPU (the
// candidates as upsampled cell maps and the update as nine masked
// channel-planar block sums, so that nothing gathers), and the port's plain
// forms are eager PyTorch with (V, H, W, 5) gathers and (6, V, H, W) stacks.
// The reference ran them as OpenCL kernels after gSLICr (clcode.cl:447-773).
//
// slic_assign (clcode.cl:447-520), one thread per pixel: the four candidate
// clusters of the plain form in its order and with its quirks (the column's
// half-cell parity dxp moves the candidate row, the row's dyp the column;
// i_off outer, j_off inner; a candidate outside the map never wins; a strict
// < against a running best that starts at inf, so the first minimum wins;
// -1 if none wins).  The distance in the plain form's rounding:
//   cd   = ((l-L)*(l-L) + (a-A)*(a-A)) + (b-B)*(b-B)
//   sd   = (x-X)*(x-X) + (y-Y)*(y-Y)
//   dist = sqrt(cd*mcd + (cw*sd)*mxy)
// with the _rn intrinsics (the library is built with --fmad=false) and IEEE
// sqrt, so the labels are bitwise the plain form's given the same map.
//
// slic_update (clcode.cl:533-773), two launches, no atomics (float atomics
// would make the colours, and so the next labels, vary from run to run):
//   partial: a block per (view, cell row, run of cells), one thread per
//     pixel column of its cells.  Each thread walks the S rows of its home
//     cell and adds each pixel whose label is a cluster at most one cell
//     away (class (dy, dx) = cluster cell - home cell) to that class's
//     column sums in shared memory: L, a, b, y and the count (x is the
//     column's own, x * count).  Then the block adds each (cell, class)'s
//     columns in ascending order and writes (V, 9, 6, Mh*Mw) partials.
//   finalize: one thread per cluster adds the nine classes' partials of
//     its home cells (dy outer, dx inner, each home = cluster - (dy, dx)) and
//     divides; a cluster with no member is zeroed.
// That is the plain form's order of the sums (class by class; within a
// class a column's rows first, then the columns), and a label outside
// [0, Mh*Mw) or more than one cell from its pixel's home cell belongs to no
// cluster, as there.  Centre and count add integers below 2**24, so they are
// exact in any order and bitwise the plain form's; the Lab sums round in
// this order.
//
// slic_vote (clcode.cl:676-711), one thread per pixel: the labels of the
// 5x5 neighbourhood that differ from the pixel's own, rows j outer and
// columns i inner; at least 16 of them and the pixel takes the last; the
// 2-pixel border passes through.
//
// What bounds them on the card: bytes.  Each reads the image's labels and
// (assign, update) its Lab once, about 72 f32 operations a pixel at most, far
// below the f32 peak's share of those bytes.  The assignment's four
// candidates of neighbouring pixels are the same few clusters, served by
// L1; the update's partials (216 bytes a cell, written once and read once:
// about 40 % more than the image's 300 MB at 9 x 1080p) are its price for
// a fixed order without atomics.  Every output depends only on its own
// view's inputs, in an order fixed by the shapes, so a block of views gives
// the bits of the same views in a larger launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;   // assign and vote: one pixel a thread
constexpr int kClasses = 9;     // (dy, dx) in {-1, 0, 1}^2, dy outer
constexpr int kSums = 6;        // L, a, b, x, y, count
constexpr int kStaged = 5;      // a column's sums in shared memory: L, a, b, y, count
constexpr int kUpdateWidth = 128;  // pixel columns of an update block (whole cells)
constexpr int kMaxS = 256;      // the largest cell of the update (its shared memory)

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

__global__ void __launch_bounds__(kThreads) assign_kernel(
    const float* __restrict__ lab,     // (V, H, W, 3)
    const float* __restrict__ center,  // (V, Mh * Mw, 2) x, y
    const float* __restrict__ color,   // (V, Mh * Mw, 3) L, a, b
    int* __restrict__ labels,          // (V, H, W)
    int V, int H, int W, int S, int Mh, int Mw, float mcd, float mxy, float cw) {
  const long long hw = (long long)H * W;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= V * hw) return;
  const int v = (int)(idx / hw);
  const int p = (int)(idx - v * hw);
  const int row = p / W, col = p - row * W;
  const int cx = col / S, cy = row / S;
  const int dxp = (col % S + S / 2) / S;  // half-cell parity from the column
  const int dyp = (row % S + S / 2) / S;  // ... and from the row
  const float l = lab[3 * idx], a = lab[3 * idx + 1], b = lab[3 * idx + 2];
  const float xf = (float)col, yf = (float)row;
  const float* cen = center + 2LL * v * Mh * Mw;
  const float* col3 = color + 3LL * v * Mh * Mw;
  float best = CUDART_INF_F;
  int best_id = -1;
#pragma unroll
  for (int i_off = -1; i_off <= 0; ++i_off) {
#pragma unroll
    for (int j_off = -1; j_off <= 0; ++j_off) {
      const int qy = cy + dxp + i_off;  // the parity swap
      const int qx = cx + dyp + j_off;
      if (qy < 0 || qy >= Mh || qx < 0 || qx >= Mw) continue;  // inf never beats best
      const int cid = qy * Mw + qx;
      const float cd = __fadd_rn(__fadd_rn(sq(__fsub_rn(l, col3[3 * cid])), sq(__fsub_rn(a, col3[3 * cid + 1]))),
                                 sq(__fsub_rn(b, col3[3 * cid + 2])));
      const float sd = __fadd_rn(sq(__fsub_rn(xf, cen[2 * cid])), sq(__fsub_rn(yf, cen[2 * cid + 1])));
      const float dist = __fsqrt_rn(__fadd_rn(__fmul_rn(cd, mcd), __fmul_rn(__fmul_rn(cw, sd), mxy)));
      if (dist < best) {
        best = dist;
        best_id = cid;
      }
    }
  }
  labels[idx] = best_id;
}

// Grid (runs of cpb cells, Mh, V); cpb * S <= kMaxS threads, thread t on
// pixel column run * cpb * S + t.  Shared memory: kClasses * kStaged rows
// of blockDim.x column sums, the thread fastest.
__global__ void __launch_bounds__(kMaxS) update_partial_kernel(
    const float* __restrict__ lab,     // (V, H, W, 3)
    const int* __restrict__ labels,    // (V, H, W)
    float* __restrict__ partial,       // (V, kClasses, kSums, Mh * Mw)
    int H, int W, int S, int Mh, int Mw, int cpb) {
  extern __shared__ float s_col[];
  const int T = blockDim.x, t = threadIdx.x;
  const int cy = blockIdx.y, v = blockIdx.z;
  const int cell0 = blockIdx.x * cpb;
  const int cx = cell0 + t / S;
  const int col = cell0 * S + t;
  const int N = Mh * Mw;
  for (int k = 0; k < kClasses * kStaged; ++k) s_col[k * T + t] = 0.0f;
  if (cx < Mw && col < W) {
    for (int r = 0; r < S; ++r) {
      const int row = cy * S + r;
      if (row >= H) break;
      const long long pix = ((long long)v * H + row) * W + col;
      const int lbl = labels[pix];
      if (lbl < 0 || lbl >= N) continue;  // no cluster's: never divide a negative label
      const int gy = lbl / Mw;
      const int dy = gy - cy, dx = lbl - gy * Mw - cx;
      if (dy < -1 || dy > 1 || dx < -1 || dx > 1) continue;  // outside the cluster's window
      float* acc = s_col + ((dy + 1) * 3 + (dx + 1)) * kStaged * T + t;
      acc[0] = __fadd_rn(acc[0], lab[3 * pix]);
      acc[T] = __fadd_rn(acc[T], lab[3 * pix + 1]);
      acc[2 * T] = __fadd_rn(acc[2 * T], lab[3 * pix + 2]);
      acc[3 * T] = __fadd_rn(acc[3 * T], (float)row);
      acc[4 * T] = __fadd_rn(acc[4 * T], 1.0f);
    }
  }
  __syncthreads();
  // each (cell, class, sum): its S columns in ascending order, cell fastest
  // so that the stores of a warp fall on neighbouring cells
  for (int i = t; i < cpb * kClasses * kSums; i += T) {
    const int j = i % cpb, kq = i / cpb;
    const int q = kq % kSums, k = kq / kSums;
    const int hx = cell0 + j;
    if (hx >= Mw) continue;
    const float* rows_of = s_col + k * kStaged * T + j * S;
    float acc = 0.0f;
    for (int c = 0; c < S; ++c) {
      float val;
      if (q == 3)  // x: the column's x times its count, exact
        val = __fmul_rn((float)(hx * S + c), rows_of[4 * T + c]);
      else
        val = rows_of[(q < 3 ? q : q - 1) * T + c];
      acc = __fadd_rn(acc, val);
    }
    partial[(((long long)v * kClasses + k) * kSums + q) * N + cy * Mw + hx] = acc;
  }
}

__global__ void __launch_bounds__(kThreads) update_finalize_kernel(
    const float* __restrict__ partial,  // (V, kClasses, kSums, Mh * Mw)
    float* __restrict__ center,         // (V, Mh * Mw, 2)
    float* __restrict__ color,          // (V, Mh * Mw, 3)
    float* __restrict__ count,          // (V, Mh * Mw)
    int V, int Mh, int Mw) {
  const int N = Mh * Mw;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)V * N) return;
  const int v = (int)(idx / N), cell = (int)(idx - (long long)v * N);
  const int ty = cell / Mw, tx = cell - ty * Mw;
  float sum[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int hy = ty - dy, hx = tx - dx;  // members of home cell (hy, hx) in class (dy, dx)
      if (hy < 0 || hy >= Mh || hx < 0 || hx >= Mw) continue;
      const float* pk = partial + ((long long)v * kClasses + (dy + 1) * 3 + (dx + 1)) * kSums * N + hy * Mw + hx;
#pragma unroll
      for (int q = 0; q < kSums; ++q) sum[q] = __fadd_rn(sum[q], pk[(long long)q * N]);
    }
  }
  const float n = sum[5];
  const bool nz = n > 0.0f;
  for (int q = 0; q < 3; ++q) color[3 * idx + q] = nz ? __fdiv_rn(sum[q], n) : 0.0f;
  for (int q = 0; q < 2; ++q) center[2 * idx + q] = nz ? __fdiv_rn(sum[3 + q], n) : 0.0f;
  count[idx] = nz ? n : 0.0f;
}

__global__ void __launch_bounds__(kThreads) vote_kernel(
    const int* __restrict__ in,  // (V, H, W)
    int* __restrict__ out,       // (V, H, W)
    int V, int H, int W) {
  const long long hw = (long long)H * W;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= V * hw) return;
  const int p = (int)(idx % hw);
  const int row = p / W, col = p - row * W;
  const int own = in[idx];
  if (row < 2 || col < 2 || row >= H - 2 || col >= W - 2) {
    out[idx] = own;
    return;
  }
  int differ = 0, last = -1;
#pragma unroll
  for (int j = -2; j <= 2; ++j) {
#pragma unroll
    for (int i = -2; i <= 2; ++i) {
      const int nl = __ldg(in + idx + (long long)j * W + i);
      if (nl != own) {
        ++differ;
        last = nl;
      }
    }
  }
  out[idx] = differ >= 16 ? last : own;
}

unsigned int blocks_of(long long n, int threads) { return (unsigned int)((n + threads - 1) / threads); }

bool too_many_blocks(long long n, int threads) { return (n + threads - 1) / threads > 0x7fffffffLL; }

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on ``stream``,
// does not synchronise and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes it does not take.

// labels (V, H, W) int32 from lab (V, H, W, 3) and the map's center
// (V, Mh*Mw, 2) and color (V, Mh*Mw, 3); S the cell size; mcd, mxy the
// squared normalisers and cw the spatial weight (SlicParams).
extern "C" int slic_assign_launch(const float* lab, const float* center, const float* color, int* labels,
                                  int V, int H, int W, int S, int Mh, int Mw, float mcd, float mxy,
                                  float cw, void* stream) {
  const long long n = (long long)V * H * W;
  if (n == 0) return 0;
  if (S < 1 || too_many_blocks(n, kThreads)) return (int)cudaErrorInvalidValue;
  assign_kernel<<<blocks_of(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lab, center, color, labels, V, H, W, S, Mh, Mw, mcd, mxy, cw);
  return (int)cudaGetLastError();
}

// The map's center (V, Mh*Mw, 2), color (V, Mh*Mw, 3) and count (V, Mh*Mw)
// from lab (V, H, W, 3) and labels (V, H, W); ``partial`` is scratch of
// V * 9 * 6 * Mh * Mw floats.  The cells must cover the image
// (Mh * S >= H, Mw * S >= W) and S be at most kMaxS.  Two launches.
extern "C" int slic_update_launch(const float* lab, const int* labels, float* partial, float* center,
                                  float* color, float* count, int V, int H, int W, int S, int Mh, int Mw,
                                  void* stream) {
  const long long cells = (long long)V * Mh * Mw;
  if (cells == 0) return 0;
  if (S < 1 || S > kMaxS || (long long)Mh * S < H || (long long)Mw * S < W || Mh > 65535 || V > 65535 ||
      too_many_blocks(cells, kThreads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpb = S >= kUpdateWidth ? 1 : kUpdateWidth / S;
  const int threads = cpb * S;
  const size_t smem = sizeof(float) * kClasses * kStaged * threads;
  const dim3 grid((unsigned int)((Mw + cpb - 1) / cpb), (unsigned int)Mh, (unsigned int)V);
  update_partial_kernel<<<grid, threads, smem, s>>>(lab, labels, partial, H, W, S, Mh, Mw, cpb);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  update_finalize_kernel<<<blocks_of(cells, kThreads), kThreads, 0, s>>>(partial, center, color, count, V, Mh,
                                                                         Mw);
  return (int)cudaGetLastError();
}

// out (V, H, W) int32: one round of the connectivity vote on ``in``.
extern "C" int slic_vote_launch(const int* in, int* out, int V, int H, int W, void* stream) {
  const long long n = (long long)V * H * W;
  if (n == 0) return 0;
  if (too_many_blocks(n, kThreads)) return (int)cudaErrorInvalidValue;
  vote_kernel<<<blocks_of(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, out, V, H, W);
  return (int)cudaGetLastError();
}
