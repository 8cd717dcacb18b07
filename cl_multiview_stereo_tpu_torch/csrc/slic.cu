// SLIC superpixel segmentation's three per-pixel loops, for Hopper (sm_90a):
// the assignment, the cluster update and the connectivity vote of
// ops/slic.py; and the seeds' edge snap.
//
// Replaces cl_multiview_stereo_tpu/ops/slic.py: find_center_association
// (:102), update_cluster_centers (:178) and suppress_local_labels (:340),
// and compute_edges (:261) with apply_edge_snap (:300).
// Those are XLA, not Pallas: the JAX package shaped them for the TPU (the
// candidates as upsampled cell maps and the update as nine masked
// channel-planar block sums, so that nothing gathers), and the port's plain
// forms are eager PyTorch with (V, H, W, 5) gathers and (6, V, H, W) stacks.
// The reference ran them as OpenCL kernels after gSLICr (clcode.cl:447-773).
//
// slic_assign and slic_update's first kernel share one layout: a block per
// (run of cpb whole cells, cell row cy, view v), threads (min(S, 128), cpb);
// thread (tx, j) owns pixel column tx of cell c0 + j (and tx + 128, ... when
// S > 128) and walks the cell row's S rows.  Nothing is divided per pixel:
// the column's half-cell parity dxp = (tx + S/2) / S is the compare
// tx >= S - S/2, and a row's dyp the same compare of its row.  A column's
// rows are read by batched register loads, every load of a batch issued
// before the arithmetic that needs it, and a thread's first batch before
// anything else it does.  Not a cp.async stage into shared memory: each
// pixel is read once, by one thread, so a stage saves no byte and adds a
// shared-memory round trip and a barrier (a staged update, with 16-byte
// copies where the rows allow them, was slower in a trial build); a warp's
// loads of a row cover one contiguous run of 32 x 12 bytes, which L1
// merges, at any width and alignment (W * 12 bytes need not be a multiple
// of 16).
//
// slic_assign (clcode.cl:447-520): the four candidate clusters of the plain
// form in its order and with its quirks (the column's half-cell parity dxp
// moves the candidate row, the row's dyp the column; i_off outer, j_off
// inner; a candidate outside the map never wins; a strict < against a
// running best that starts at inf, so the first minimum wins; -1 if none
// wins).  The distance in the plain form's rounding:
//   cd   = ((l-L)*(l-L) + (a-A)*(a-A)) + (b-B)*(b-B)
//   sd   = (x-X)*(x-X) + (y-Y)*(y-Y)
//   dist = sqrt(cd*mcd + (cw*sd)*mxy)
// with the _rn intrinsics (the library is built with --fmad=false) and IEEE
// sqrt, never squared distances compared (the rounded sqrt ties values that
// differ), so the labels are bitwise the plain form's given the same map.
// The block stages its candidates once: cell rows cy-1..cy+1 by columns
// c0-1..c0+cpb, x, y, L, a, b as structure of arrays in shared memory, an
// off-map cell as NaN (its distance is NaN, which never passes the strict <,
// as the plain form's inf never does).  A column's dxp picks two of the
// three rows and dyp two of its three cells, so each thread copies its six
// candidates into registers once, with the column's (x-X)*(x-X) already
// squared.  The rows of each dyp are walked kHalf at a time, the two runs
// side by side in straight-line code (the candidate set is a template
// argument, not a branch a row), so 2 * kHalf pixels' four distances are in
// flight together; the labels are written one coalesced row at a time.
//
// slic_update (clcode.cl:533-773), two launches, no atomics (float atomics
// would make the colours, and so the next labels, vary from run to run):
//   partial: each thread keeps its column's 9 x 5 sums (L, a, b, y and the
//     count of each class (dy, dx) = cluster cell - home cell) in
//     registers.  A pixel's class is the one whose cluster id
//     (cy+dy)*Mw + cx+dx equals its label; the add of the other eight is
//     predicated off, which is the plain form's add of +0.0 (a sum that
//     starts at +0.0 is never -0.0, and s + 0.0 == s).  Ids of clusters on
//     the map are distinct; a class whose cluster lies off the map has an id
//     that a label may match, but the finalize never reads that class of
//     that home cell, so a label outside [0, Mh*Mw) or more than one cell
//     away adds to nothing that is read.  Each thread then writes its
//     column sums to shared memory once, each cell's S columns in a row of
//     P = S or S + 1 (odd) floats, and the block adds each (cell, class,
//     sum)'s S columns in ascending order (x as the column's x times its
//     count, exact), a warp's lanes on neighbouring cells and each thread
//     on kInterleave such sums side by side: the odd stride puts a warp's
//     reads on distinct banks but where two (class, sum) rows meet, at most
//     2-way, and the writes are at most 2-way too.  It writes
//     (V, 9, 6, Mh*Mw) partials.
//   finalize: one thread per cluster adds the nine classes' partials of
//     its home cells (dy outer, dx inner, each home = cluster - (dy, dx)) and
//     divides; a cluster with no member is zeroed.
// That is the plain form's order of the sums (class by class; within a
// class a column's rows first, then the columns), and a label outside
// [0, Mh*Mw) or more than one cell from its pixel's home cell belongs to no
// cluster, as there.  Centre and count add integers below 2**24, so they are
// exact in any order; the Lab sums round in this order, bitwise the plain
// form's.  The partials (216 bytes a cell, 63 MB at 9 x 1080p, written once
// and read once: 0.038 ms at the byte rate) are the price of that order
// without atomics.  A cluster's sums need its home cells one row above and
// below, which other blocks hold: thread-block clusters could pass them
// through distributed shared memory only inside a cluster of cell rows, so
// its first and last rows would still go through memory or read their
// neighbours' pixels again, and the finalize stays a launch of its own.
// Writing only the partials of classes with members, and reading them
// only there, was slower in a trial build.
//
// slic_vote (clcode.cl:676-711), one round a launch: the labels of the 5x5
// neighbourhood that differ from the pixel's own, rows j outer and columns
// i inner; at least 16 of them and the pixel takes the last; the 2-pixel
// border passes through.  A 3-D grid (column bands, row bands, views), a
// thread a patch of 4 x 4 pixels, its row and column from the grid, so
// nothing is divided a pixel; the patch's 8 x 8 window sits in registers,
// each of its rows in by three 16-byte loads through L1 (the vectors left
// and right of the run give their inner two labels), 1.5 loads a pixel
// against 25, and each row of the patch leaves by one 16-byte store.  A
// tap is one compare and one predicated add in place (PTX; C++ gave a
// select between two registers, 3 instructions a tap); the last differing
// label comes from the scan's last 9 taps alone (at >= 16 of 24 differing
// at most 8 are equal), so 9 predicated moves, not 24.  A width that is
// not a multiple of 4 or a base off 16-byte alignment takes the same
// arithmetic a pixel a thread from 4-byte loads, in the same kernel
// template.  The window staged by cp.async in shared memory was slower.
// Offsets are 64-bit at every size: a copy with 32-bit offsets below 2^31
// elements timed the same at 9 x 1080p.
//
// edge_snap (apply_edge_alternative, clcode.cl:204-248, on the edge image
// of edge_compute_alternative, :161-195), one thread a seed centre.  The
// plain form (ops/slic.apply_edge_snap on compute_edges) builds the Sobel
// magnitude of every pixel from 12 border-replicate copies of the whole Lab
// image, then reads it at 9 pixels a centre, under 2 % of them.  The
// kernel computes the magnitude only there: the centre (C truncation, then
// clamped into the view) and its 8 ring pixels.  Their taps all lie in the
// 5x5 block around the clamped centre, read once a channel with the rows
// and columns clamped into the view: a ring pixel in the view lies at most
// one pixel from the clamped centre, so its taps, clamped, are that
// block's, as the plain form's border-replicate reads are.  The magnitude
// keeps compute_edges' order exactly:
//   DX = ((((-t(-1,-1) + t(1,-1)) - 2 t(-1,0)) + 2 t(1,0)) - t(-1,1)) + t(1,1)
//   DY = ((((-t(-1,-1) - 2 t(0,-1)) - t(1,-1)) + t(-1,1)) + 2 t(0,1)) + t(1,1)
//   edge = sqrt((sq_L + sq_a) + sq_b),  sq = DX * DX + DY * DY
// with the _rn intrinsics and the IEEE square root, so each magnitude is
// bitwise the whole image's at that pixel.  Then the ring scan in
// _EDGE_RING order (w, nw, n, ne, e, se, s, sw), a ring pixel in the view
// taking the centre with a strict < against the running lowest (the first
// minimum wins); a moved centre takes that pixel's (x, y) and Lab colour,
// an unmoved one keeps its own.  Bound: the bytes, the Lab sectors of the
// blocks (about 25 pixels a centre) and the seeds in and out.
//
// What bounds them on an NVIDIA H100 80GB HBM3 at 700 W (tools/sass.py for
// the code, tools/roofline.py and chip_smoke.py for the times, at 9 x 1080p
// with S = 8).  The first forms of the assignment and the update (one
// thread a pixel; column sums read back at a stride of S floats) took
// 0.29 and 0.31 ms against byte bounds of 0.091 ms: the assignment issued a
// 64-bit division, five 32-bit ones and 20 bounds-tested table loads a
// pixel (539 static SASS instructions, 32 registers), the update's column
// sums 8-way bank conflicts (942 instructions).  These forms (1601 and
// 1144 instructions, 80 registers each, six blocks an SM) take about 0.13
// and 0.18 ms.  The assignment reads its bytes near the memory rate; what
// is left is the four exact distances a pixel, about 100 instructions with
// the IEEE sqrt, not all hidden under the loads.  The update moves its
// pixels' bytes, the partials' 63 MB out and back and the finalize's own
// launch: its bound counts only the first.  The vote's first form (a
// thread a pixel: a 64-bit remainder and a division, 25 scalar loads;
// 0.139-0.144 ms against the 0.0446 ms byte bound) became this one (1,196
// SASS instructions for 16 pixels, 80 registers, no spill): 0.064 ms,
// share 0.69, on the converged labels and on round 1's output alike,
// where 37 % and 24 % of the pixels take another label.  What is left is
// issue: about 60 instructions a pixel, 0.034 ms at one warp instruction
// a clock on every scheduler, not all of it under the loads.  Every output
// depends only on its own view's inputs, in an order fixed by the shapes,
// so a block of views gives the bits of the same views in a larger launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;    // finalize: one cluster a thread
constexpr int kClasses = 9;      // (dy, dx) in {-1, 0, 1}^2, dy outer
constexpr int kSums = 6;         // L, a, b, x, y, count
constexpr int kStaged = 5;       // a column's sums: L, a, b, y, count
constexpr int kRunWidth = 128;   // pixel columns of an assign or update block (whole cells)
constexpr int kMaxS = 256;       // the largest cell of the update (its shared memory)
constexpr int kHalf = 4;         // assign: rows of each half-cell parity loaded together
constexpr int kUpdateBatch = 4;  // update: rows of a column loaded together
constexpr int kInterleave = 4;   // update: (cell, class, sum) sums a thread adds side by side
constexpr int kMinBlocks = 6;    // assign and update blocks an SM holds: at most 80 registers a thread
constexpr int kMaxGrid = 65535;  // gridDim.y and gridDim.z
constexpr int kVoteX = 32;       // vote: threads a block along a row (a warp)
constexpr int kVoteY = 4;        // vote: rows of threads a block
constexpr int kVoteRun = 4;      // vote: pixels of a row a thread where rows are 16-byte aligned
constexpr int kVoteRows = 4;     // vote: rows a thread

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

// One candidate cluster of a pixel column: its colour, its y, the column's
// (x - X)^2 and its id.
struct Candidate {
  float L, A, B, Y, dx2;
  int id;
};

// The plain form's distance to ``c`` and its strict < against the best.
__device__ __forceinline__ void consider(const Candidate& c, float l, float a, float b, float yf, float mcd,
                                         float mxy, float cw, float& best, int& best_id) {
  const float cd = __fadd_rn(__fadd_rn(sq(__fsub_rn(l, c.L)), sq(__fsub_rn(a, c.A))), sq(__fsub_rn(b, c.B)));
  const float sd = __fadd_rn(c.dx2, sq(__fsub_rn(yf, c.Y)));
  const float dist = __fsqrt_rn(__fadd_rn(__fmul_rn(cd, mcd), __fmul_rn(__fmul_rn(cw, sd), mxy)));
  if (dist < best) {  // NaN (a cell off the map) never passes
    best = dist;
    best_id = c.id;
  }
}

// The nearest of a pixel's four candidates, in the plain form's order: the
// candidate rows' two cells at columns cx - 1 + kDyp and cx + kDyp.
template <int kDyp>
__device__ __forceinline__ int nearest(const Candidate (&c)[6], const float (&px)[3], float yf, float mcd,
                                       float mxy, float cw) {
  float best = CUDART_INF_F;
  int best_id = -1;
  consider(c[kDyp], px[0], px[1], px[2], yf, mcd, mxy, cw, best, best_id);
  consider(c[kDyp + 1], px[0], px[1], px[2], yf, mcd, mxy, cw, best, best_id);
  consider(c[kDyp + 3], px[0], px[1], px[2], yf, mcd, mxy, cw, best, best_id);
  consider(c[kDyp + 4], px[0], px[1], px[2], yf, mcd, mxy, cw, best, best_id);
  return best_id;
}

// Lab of rows r0 .. r0 + kHalf - 1 of the column at pix0 (a row past the
// cell's last is read as its last, and its label never stored).
__device__ __forceinline__ void load_rows(const float* __restrict__ lab, long long pix0, int W, int r0, int rows,
                                          float (&px)[kHalf][3]) {
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float* q = lab + 3 * (pix0 + (long long)min(r0 + i, rows - 1) * W);
    px[i][0] = __ldg(q);
    px[i][1] = __ldg(q + 1);
    px[i][2] = __ldg(q + 2);
  }
}

// Grid (runs of cpb cells, <= Mh, <= V) striding over cell rows and views;
// threads (min(S, kRunWidth), cpb).  A column's rows r < split (dyp = 0)
// and r >= split (dyp = 1) go in pairs of batches, each batch straight-line
// code over its kHalf rows: the first pair's loads are issued before the
// block stages its candidates.
__global__ void __launch_bounds__(kRunWidth, kMinBlocks) assign_kernel(
    const float* __restrict__ lab,     // (V, H, W, 3)
    const float* __restrict__ center,  // (V, Mh * Mw, 2) x, y
    const float* __restrict__ color,   // (V, Mh * Mw, 3) L, a, b
    int* __restrict__ labels,          // (V, H, W)
    int V, int H, int W, int S, int Mh, int Mw, int cpb, float mcd, float mxy, float cw) {
  // x, y, L, a, b of cell rows cy-1..cy+1, cell columns c0-1..c0+cpb
  __shared__ float s_cand[kStaged][3][kRunWidth + 2];
  const int bx = blockDim.x, j = threadIdx.y;
  const int tid = j * bx + threadIdx.x, nthreads = bx * blockDim.y;
  const int c0 = blockIdx.x * cpb, cx = c0 + j;
  const int tw = cpb + 2, N = Mh * Mw;
  const int split = S - S / 2;  // rows r >= split have dyp = 1
  for (int v = blockIdx.z; v < V; v += gridDim.z) {
    for (int cy = blockIdx.y; cy < Mh; cy += gridDim.y) {
      const int rows = min(S, H - cy * S);
      const int n0 = min(split, rows), n1 = rows - split;  // rows of each parity
      int tx = threadIdx.x, col = cx * S + tx;
      bool active = cx < Mw && col < W && rows > 0;
      long long pix0 = ((long long)v * H + (long long)cy * S) * W + col;
      float p0[kHalf][3], p1[kHalf][3];
      if (active) {
        load_rows(lab, pix0, W, 0, rows, p0);
        load_rows(lab, pix0, W, split, rows, p1);
      }
      for (int i = tid; i < 3 * tw; i += nthreads) {
        const int ry = i / tw, rx = i - ry * tw;
        const int qy = cy - 1 + ry, qx = c0 - 1 + rx;
        float f[kStaged] = {CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F};
        if (qy >= 0 && qy < Mh && qx >= 0 && qx < Mw) {
          const long long q = (long long)v * N + qy * Mw + qx;
          f[0] = center[2 * q];
          f[1] = center[2 * q + 1];
          f[2] = color[3 * q];
          f[3] = color[3 * q + 1];
          f[4] = color[3 * q + 2];
        }
#pragma unroll
        for (int k = 0; k < kStaged; ++k) s_cand[k][ry][rx] = f[k];
      }
      __syncthreads();
      bool loaded = true;
      while (active) {
        const int dxp = tx >= split ? 1 : 0;  // the column's half-cell parity: the candidate row
        const float xf = (float)col;
        // c[rr * 3 + cc]: cell row cy - 1 + dxp + rr, cell column cx - 1 + cc
        Candidate c[6];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) {
            Candidate& d = c[rr * 3 + cc];
            const int ry = dxp + rr, rx = j + cc;
            d.dx2 = sq(__fsub_rn(xf, s_cand[0][ry][rx]));
            d.Y = s_cand[1][ry][rx];
            d.L = s_cand[2][ry][rx];
            d.A = s_cand[3][ry][rx];
            d.B = s_cand[4][ry][rx];
            d.id = (cy - 1 + ry) * Mw + (cx - 1 + cc);
          }
        }
        for (int b = 0; b < n0; b += kHalf) {
          if (!loaded) {
            load_rows(lab, pix0, W, b, rows, p0);
            load_rows(lab, pix0, W, split + b, rows, p1);
          }
          loaded = false;
          const float y0 = (float)(cy * S + b), y1 = (float)(cy * S + split + b);
#pragma unroll
          for (int i = 0; i < kHalf; ++i) {
            const int id = nearest<0>(c, p0[i], __fadd_rn(y0, (float)i), mcd, mxy, cw);
            if (b + i < n0) labels[pix0 + (long long)(b + i) * W] = id;
          }
#pragma unroll
          for (int i = 0; i < kHalf; ++i) {
            const int id = nearest<1>(c, p1[i], __fadd_rn(y1, (float)i), mcd, mxy, cw);
            if (b + i < n1) labels[pix0 + (long long)(split + b + i) * W] = id;
          }
        }
        tx += bx;  // the next column of the cell when S > kRunWidth
        col += bx;
        pix0 += bx;
        active = tx < S && col < W;
        loaded = false;
      }
      __syncthreads();  // before the next cell row restages
    }
  }
}

// Labels and Lab of rows r0 .. r0 + kUpdateBatch - 1 of the column at pix0
// (a row past the cell's last is read as its last, and never added).
__device__ __forceinline__ void load_members(const int* __restrict__ labels, const float* __restrict__ lab,
                                             long long pix0, int W, int r0, int rows, int (&lbl)[kUpdateBatch],
                                             float (&px)[kUpdateBatch][3]) {
#pragma unroll
  for (int i = 0; i < kUpdateBatch; ++i) {
    const long long pix = pix0 + (long long)min(r0 + i, rows - 1) * W;
    lbl[i] = __ldg(labels + pix);
    px[i][0] = __ldg(lab + 3 * pix);
    px[i][1] = __ldg(lab + 3 * pix + 1);
    px[i][2] = __ldg(lab + 3 * pix + 2);
  }
}

// Grid (runs of cpb cells, Mh, V); threads (min(S, kRunWidth), cpb).
// Shared memory: kClasses * kStaged planes of cpb rows of P floats (P odd),
// column tx of cell j at j * P + tx.  The first batch of a thread's rows is
// loaded before anything else.
__global__ void __launch_bounds__(kRunWidth, kMinBlocks) update_partial_kernel(
    const float* __restrict__ lab,     // (V, H, W, 3)
    const int* __restrict__ labels,    // (V, H, W)
    float* __restrict__ partial,       // (V, kClasses, kSums, Mh * Mw)
    int H, int W, int S, int Mh, int Mw, int cpb, int P) {
  extern __shared__ float s_col[];
  const int bx = blockDim.x, j = threadIdx.y;
  const int tid = j * bx + threadIdx.x, nthreads = bx * blockDim.y;
  const int cy = blockIdx.y, v = blockIdx.z;
  const int c0 = blockIdx.x * cpb, cx = c0 + j;
  const int N = Mh * Mw, plane = cpb * P;
  const int rows = min(S, H - cy * S);
  const long long row0 = ((long long)v * H + (long long)cy * S) * W;  // pixel (cy * S, 0)
  int lbl[kUpdateBatch];
  float px[kUpdateBatch][3];
  bool loaded = cx < Mw && cx * S + (int)threadIdx.x < W && rows > 0;
  if (loaded) load_members(labels, lab, row0 + cx * S + threadIdx.x, W, 0, rows, lbl, px);
  // the cluster id of each class (dy, dx), dy outer
  int ids[kClasses];
#pragma unroll
  for (int k = 0; k < kClasses; ++k) ids[k] = (cy + k / 3 - 1) * Mw + cx + k % 3 - 1;
  for (int tx = threadIdx.x; tx < S; tx += bx) {
    const int col = cx * S + tx;
    float acc[kClasses][kStaged];
#pragma unroll
    for (int k = 0; k < kClasses; ++k) {
#pragma unroll
      for (int q = 0; q < kStaged; ++q) acc[k][q] = 0.0f;
    }
    if (cx < Mw && col < W && rows > 0) {
      for (int r0 = 0; r0 < rows; r0 += kUpdateBatch) {
        if (!loaded) load_members(labels, lab, row0 + col, W, r0, rows, lbl, px);
        loaded = false;
#pragma unroll
        for (int i = 0; i < kUpdateBatch; ++i) {
          const int r = r0 + i;
          if (r >= rows) break;
          const float yf = (float)(cy * S + r);
#pragma unroll
          for (int k = 0; k < kClasses; ++k) {
            if (lbl[i] == ids[k]) {
              acc[k][0] = __fadd_rn(acc[k][0], px[i][0]);
              acc[k][1] = __fadd_rn(acc[k][1], px[i][1]);
              acc[k][2] = __fadd_rn(acc[k][2], px[i][2]);
              acc[k][3] = __fadd_rn(acc[k][3], yf);
              acc[k][4] = __fadd_rn(acc[k][4], 1.0f);
            }
          }
        }
      }
    }
    float* dst = s_col + j * P + tx;
#pragma unroll
    for (int k = 0; k < kClasses; ++k) {
#pragma unroll
      for (int q = 0; q < kStaged; ++q) dst[(k * kStaged + q) * plane] = acc[k][q];
    }
  }
  __syncthreads();
  // each (cell, class, sum): its S columns in ascending order.  Item
  // i = (k * kSums + q) * cpb + jj, cell fastest, so that a warp's 32 lanes
  // read 32 neighbouring items; a thread adds kInterleave items side by side.
  const int items = kClasses * kSums * cpb;
  const long long out0 = (long long)v * kClasses * kSums * N + (long long)cy * Mw + c0;
  for (int i0 = tid; i0 < items; i0 += kInterleave * nthreads) {
    int off[kInterleave], kq[kInterleave], jj[kInterleave];
    float xs[kInterleave], sum[kInterleave];
#pragma unroll
    for (int g = 0; g < kInterleave; ++g) {
      const int i = min(i0 + g * nthreads, items - 1);
      kq[g] = i / cpb;
      jj[g] = i - kq[g] * cpb;
      const int k = kq[g] / kSums, q = kq[g] - k * kSums;
      // x (q = 3) and the count (q = 5) read the staged count, y (q = 4) the staged y
      off[g] = (k * kStaged + (q < 3 ? q : (q == 4 ? 3 : 4))) * plane + jj[g] * P;
      xs[g] = q == 3 ? (float)((c0 + jj[g]) * S) : -1.0f;  // x: the column's x times its count, exact
      sum[g] = 0.0f;
      if (i0 + g * nthreads >= items || c0 + jj[g] >= Mw) kq[g] = -1;
    }
#pragma unroll 4
    for (int c = 0; c < S; ++c) {
#pragma unroll
      for (int g = 0; g < kInterleave; ++g) {
        const float s = s_col[off[g] + c];
        sum[g] = __fadd_rn(sum[g], xs[g] >= 0.0f ? __fmul_rn(__fadd_rn(xs[g], (float)c), s) : s);
      }
    }
#pragma unroll
    for (int g = 0; g < kInterleave; ++g)
      if (kq[g] >= 0) partial[out0 + (long long)kq[g] * N + jj[g]] = sum[g];
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

// One tap of the vote: differ += q != own, and with ``take``, last = q where
// q != own (``take`` is constant once the taps' loop is unrolled).  In PTX,
// so that a tap is one compare and one or two adds or moves predicated on
// it, in place (C++ compiles each tap to a compare and a select between
// two registers: 3 instructions a tap).
__device__ __forceinline__ void vote_tap(int q, int own, int& differ, int& last, bool take) {
  if (take)
    asm("{\n\t.reg .pred p;\n\tsetp.ne.s32 p, %2, %3;\n\t@p add.s32 %0, %0, 1;\n\t@p mov.b32 %1, %2;\n\t}"
        : "+r"(differ), "+r"(last)
        : "r"(q), "r"(own));
  else
    asm("{\n\t.reg .pred p;\n\tsetp.ne.s32 p, %1, %2;\n\t@p add.s32 %0, %0, 1;\n\t}"
        : "+r"(differ)
        : "r"(q), "r"(own));
}

// One pixel's vote from its 5x5 window w[r..r+4][c..c+4] around
// w[r+2][c+2]: the labels that differ from its own, counted over the 24
// taps, and the last of them in the plain form's scan (rows j outer,
// columns i inner), taken from the scan's last 9 taps alone: where 16 or
// more of the 24 differ, at most 8 are equal, so one of the last 9 differs.
template <int kR, int kC>
__device__ __forceinline__ int vote_at(const int (&w)[kR][kC], int r, int c) {
  const int own = w[r + 2][c + 2];
  int differ = 0, last = own;
#pragma unroll
  for (int k = 0; k < 25; ++k) vote_tap(w[r + k / 5][c + k % 5], own, differ, last, k >= 25 - 9);
  return differ >= 16 ? last : own;
}

// Columns x0 - 2 .. x0 + kRun + 1 of one row into w, ``row`` at column x0,
// 16-byte aligned, through L1: the vector left of the run (its last two),
// the run's kRun / 4, the vector right of it (its first two).  A side
// vector outside the view (``left``, ``right`` false) reads as 0; only
// border pixels, which pass through, see it.
template <int kRun>
__device__ __forceinline__ void load_run(const int* row, bool left, bool right, int (&w)[kRun + 4]) {
  const int4 a = left ? __ldg(reinterpret_cast<const int4*>(row - 4)) : make_int4(0, 0, 0, 0);
  w[0] = a.z, w[1] = a.w;
#pragma unroll
  for (int k = 0; k < kRun / 4; ++k) {
    const int4 b = __ldg(reinterpret_cast<const int4*>(row + 4 * k));
    w[2 + 4 * k] = b.x, w[3 + 4 * k] = b.y, w[4 + 4 * k] = b.z, w[5 + 4 * k] = b.w;
  }
  const int4 c = right ? __ldg(reinterpret_cast<const int4*>(row + kRun)) : make_int4(0, 0, 0, 0);
  w[kRun + 2] = c.x, w[kRun + 3] = c.y;
}

// Grid (bands of kVoteX * kRun columns, bands of kVoteY * kVoteRows rows,
// views), looping past kMaxGrid on y and z; a thread the kVoteRows x kRun
// pixels at (y0, x0), its row and column from the grid, and their
// (kVoteRows + 4) x (kRun + 4) window in registers.  kRun = 4: the
// window's rows in by 16-byte loads and the run out by a 16-byte store (W
// a multiple of 4, both bases 16-byte aligned); kRun = 1: any width and
// alignment, the window's columns clamped into the view, 4-byte loads.
// Rows are clamped into the view; only border rows see a clamped one.
// Offsets are 64-bit; rows, columns and views are compared and clamped as
// distances to the view's end, so none of them wraps at any int size.
template <int kRun>
__global__ void __launch_bounds__(kVoteX * kVoteY) vote_kernel(
    const int* __restrict__ in,  // (V, H, W)
    int* __restrict__ out,       // (V, H, W)
    int V, int H, int W) {
  static_assert(kRun == 1 || kRun % 4 == 0, "a run is one pixel or whole 16-byte vectors");
  constexpr int kBand = kVoteY * kVoteRows;
  const unsigned ux0 = (blockIdx.x * kVoteX + threadIdx.x) * kRun;
  if (ux0 >= (unsigned)W) return;
  const int x0 = (int)ux0;
  bool col_in[kRun];
#pragma unroll
  for (int c = 0; c < kRun; ++c) col_in[c] = x0 >= 2 - c && c < W - 2 - x0;
  const long long hw = (long long)H * W;
  const int y_step = (int)gridDim.y * kBand, v_step = (int)gridDim.z;
  for (int v = blockIdx.z; v < V; v = V - v > v_step ? v + v_step : V) {
    const int* __restrict__ plane = in + v * hw;
    int* __restrict__ dst = out + v * hw;
    for (int y0 = blockIdx.y * kBand + threadIdx.y * kVoteRows; y0 < H; y0 = H - y0 > y_step ? y0 + y_step : H) {
      int w[kVoteRows + 4][kRun + 4];
#pragma unroll
      for (int r = 0; r < kVoteRows + 4; ++r) {
        const int dy = r < 2 ? max(r - 2, -y0) : min(r - 2, H - 1 - y0);
        const int* row = plane + (long long)(y0 + dy) * W + x0;
        if constexpr (kRun == 1) {
#pragma unroll
          for (int i = 0; i < 5; ++i) w[r][i] = __ldg(row + (i < 2 ? max(i - 2, -x0) : min(i - 2, W - 1 - x0)));
        } else {
          load_run<kRun>(row, x0 > 0, kRun < W - x0, w[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kVoteRows; ++r) {
        if (r >= H - y0) break;
        const bool row_in = y0 >= 2 - r && r < H - 2 - y0;
        int res[kRun];
#pragma unroll
        for (int c = 0; c < kRun; ++c) res[c] = row_in && col_in[c] ? vote_at(w, r, c) : w[r + 2][c + 2];
        int* o = dst + (long long)(y0 + r) * W + x0;
        if constexpr (kRun == 1) {
          o[0] = res[0];
        } else {
#pragma unroll
          for (int k = 0; k < kRun / 4; ++k)
            reinterpret_cast<int4*>(o)[k] = make_int4(res[4 * k], res[4 * k + 1], res[4 * k + 2], res[4 * k + 3]);
        }
      }
    }
  }
}

constexpr int kSnapThreads = 128;  // edge_snap: one seed centre a thread

// a + b with two's-complement wrap, as torch's int64 add on the card
__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

// c clamped into [0, n - 1], as torch's clamp of an int64 index
__device__ __forceinline__ int clamp_index(long long c, int n) { return c < 0 ? 0 : (c >= n ? n - 1 : (int)c); }

// ring slot q's (dx, dy) in the order w, nw, n, ne, e, se, s, sw
// (_EDGE_RING, clcode.cl:215)
__device__ __forceinline__ int ring_dx(int q) { return q == 0 || q == 1 || q == 7 ? -1 : (q == 2 || q == 6 ? 0 : 1); }
__device__ __forceinline__ int ring_dy(int q) { return q == 0 || q == 4 ? 0 : (q < 4 ? -1 : 1); }

// of three values, the one at offset o in {-1, 0, 1}
__device__ __forceinline__ float pick3(float a, float b, float c, int o) { return o < 0 ? a : (o == 0 ? b : c); }

__global__ void __launch_bounds__(kSnapThreads) edge_snap_kernel(
    const float* __restrict__ lab,     // (V, H, W, 3)
    const float* __restrict__ center,  // (V * cells, 2)
    const float* __restrict__ color,   // (V * cells, 3)
    float* __restrict__ center_out,    // (V * cells, 2)
    float* __restrict__ color_out,     // (V * cells, 3)
    int V, int H, int W, int cells) {
  const long long idx = (long long)blockIdx.x * kSnapThreads + threadIdx.x;
  if (idx >= (long long)V * cells) return;
  const float fx = center[2 * idx], fy = center[2 * idx + 1];
  const long long cx = (long long)fx, cy = (long long)fy;  // C truncation (cvt.rzi, as torch's .to(int64))
  const int ccx = clamp_index(cx, W), ccy = clamp_index(cy, H);
  const float* __restrict__ img = lab + (idx / cells) * H * (long long)W * 3;
  long long off[5][5];  // the block's pixels, rows and columns clamped into the view
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const long long row = (long long)clamp_index((long long)ccy + k - 2, H) * W;
#pragma unroll
    for (int m = 0; m < 5; ++m) off[k][m] = 3 * (row + clamp_index((long long)ccx + m - 2, W));
  }
  // the squared gradients of the 3 x 3 pixels around the clamped centre,
  // summed over the channels in order
  float acc[3][3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float t[5][5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
#pragma unroll
      for (int m = 0; m < 5; ++m) t[k][m] = __ldg(img + off[k][m] + ch);
    }
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
#pragma unroll
      for (int ox = 0; ox < 3; ++ox) {
        // tap (dx, dy) of the pixel at block offset (ox, oy): t[oy + 1 + dy][ox + 1 + dx]
        const float(*r)[5] = t + oy;
        float gx = __fadd_rn(-r[0][ox], r[0][ox + 2]);
        gx = __fsub_rn(gx, __fmul_rn(2.0f, r[1][ox]));
        gx = __fadd_rn(gx, __fmul_rn(2.0f, r[1][ox + 2]));
        gx = __fsub_rn(gx, r[2][ox]);
        gx = __fadd_rn(gx, r[2][ox + 2]);
        float gy = __fsub_rn(-r[0][ox], __fmul_rn(2.0f, r[0][ox + 1]));
        gy = __fsub_rn(gy, r[0][ox + 2]);
        gy = __fadd_rn(gy, r[2][ox]);
        gy = __fadd_rn(gy, __fmul_rn(2.0f, r[2][ox + 1]));
        gy = __fadd_rn(gy, r[2][ox + 2]);
        const float sq = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
        acc[oy][ox] = ch == 0 ? sq : __fadd_rn(acc[oy][ox], sq);
      }
    }
  }
  float edge[3][3];
#pragma unroll
  for (int oy = 0; oy < 3; ++oy) {
#pragma unroll
    for (int ox = 0; ox < 3; ++ox) edge[oy][ox] = __fsqrt_rn(acc[oy][ox]);
  }
  // the ring scan (clcode.cl:215)
  float best = edge[1][1];
  long long bx = cx, by = cy;
  bool changed = false;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const long long nx = wrap_add(cx, ring_dx(q)), ny = wrap_add(cy, ring_dy(q));
    if (!(nx >= 0 && ny >= 0 && nx < W && ny < H)) continue;
    // a ring pixel in the view is at most one pixel from the clamped centre
    const int ox = (int)(nx - ccx), oy = (int)(ny - ccy);
    const float e = pick3(pick3(edge[0][0], edge[0][1], edge[0][2], ox), pick3(edge[1][0], edge[1][1], edge[1][2], ox),
                          pick3(edge[2][0], edge[2][1], edge[2][2], ox), oy);
    if (e < best) {
      best = e;
      bx = nx;
      by = ny;
      changed = true;
    }
  }
  if (changed) {
    const float* __restrict__ px = img + 3 * (by * W + bx);
    center_out[2 * idx] = (float)bx;
    center_out[2 * idx + 1] = (float)by;
    for (int q = 0; q < 3; ++q) color_out[3 * idx + q] = __ldg(px + q);
  } else {
    center_out[2 * idx] = fx;
    center_out[2 * idx + 1] = fy;
    for (int q = 0; q < 3; ++q) color_out[3 * idx + q] = color[3 * idx + q];
  }
}

unsigned int blocks_of(long long n, int threads) { return (unsigned int)((n + threads - 1) / threads); }

bool too_many_blocks(long long n, int threads) { return (n + threads - 1) / threads > 0x7fffffffLL; }

// The assign and update blocks: cells a block (cpb) and threads a cell
// (min(S, kRunWidth)).
int cells_per_block(int S) { return S >= kRunWidth ? 1 : kRunWidth / S; }

dim3 run_threads(int S) { return dim3((unsigned int)(S < kRunWidth ? S : kRunWidth), (unsigned int)cells_per_block(S)); }

template <int kRun>
void vote_launch(const int* in, int* out, int V, int H, int W, cudaStream_t st) {
  constexpr int kBand = kVoteY * kVoteRows;
  constexpr long long kCols = kVoteX * kRun;
  const long long bands = ((long long)H + kBand - 1) / kBand;
  const dim3 grid((unsigned int)((W + kCols - 1) / kCols), (unsigned int)(bands < kMaxGrid ? bands : kMaxGrid),
                  (unsigned int)min(V, kMaxGrid));
  vote_kernel<kRun><<<grid, dim3(kVoteX, kVoteY), 0, st>>>(in, out, V, H, W);
}

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on ``stream``,
// does not synchronise and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes it does not take.

// labels (V, H, W) int32 from lab (V, H, W, 3) and the map's center
// (V, Mh*Mw, 2) and color (V, Mh*Mw, 3); S the cell size; mcd, mxy the
// squared normalisers and cw the spatial weight (SlicParams).  The cells
// must cover the image (Mh * S >= H, Mw * S >= W).
extern "C" int slic_assign_launch(const float* lab, const float* center, const float* color, int* labels,
                                  int V, int H, int W, int S, int Mh, int Mw, float mcd, float mxy,
                                  float cw, void* stream) {
  const long long n = (long long)V * H * W;
  if (n == 0) return 0;
  if (S < 1 || (long long)Mh * S < H || (long long)Mw * S < W) return (int)cudaErrorInvalidValue;
  const int cpb = cells_per_block(S);
  const dim3 grid((unsigned int)((Mw + cpb - 1) / cpb), (unsigned int)min(Mh, kMaxGrid),
                  (unsigned int)min(V, kMaxGrid));
  assign_kernel<<<grid, run_threads(S), 0, static_cast<cudaStream_t>(stream)>>>(
      lab, center, color, labels, V, H, W, S, Mh, Mw, cpb, mcd, mxy, cw);
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
  if (S < 1 || S > kMaxS || (long long)Mh * S < H || (long long)Mw * S < W || Mh > kMaxGrid || V > kMaxGrid ||
      too_many_blocks(cells, kThreads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpb = cells_per_block(S);
  const int P = S | 1;  // a cell's columns at an odd stride: S, or S + 1 when S is even
  const size_t smem = sizeof(float) * kClasses * kStaged * cpb * P;  // below 48 KB for every S <= kMaxS
  const dim3 grid((unsigned int)((Mw + cpb - 1) / cpb), (unsigned int)Mh, (unsigned int)V);
  update_partial_kernel<<<grid, run_threads(S), smem, s>>>(lab, labels, partial, H, W, S, Mh, Mw, cpb, P);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  update_finalize_kernel<<<blocks_of(cells, kThreads), kThreads, 0, s>>>(partial, center, color, count, V, Mh,
                                                                         Mw);
  return (int)cudaGetLastError();
}

// out (V, H, W) int32: one round of the connectivity vote on ``in``.
extern "C" int slic_vote_launch(const int* in, int* out, int V, int H, int W, void* stream) {
  if (V < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if ((long long)V * H * W == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // kVoteRun pixels a thread by 16-byte loads and stores where W is a
  // multiple of it and both bases are 16-byte aligned; else one a thread
  const unsigned long long bases =
      reinterpret_cast<unsigned long long>(in) | reinterpret_cast<unsigned long long>(out);
  if (W % kVoteRun == 0 && (bases & 15) == 0)
    vote_launch<kVoteRun>(in, out, V, H, W, st);
  else
    vote_launch<1>(in, out, V, H, W, st);
  return (int)cudaGetLastError();
}

// center_out (V, cells, 2) and color_out (V, cells, 3): the seeds center
// (V, cells, 2) and color (V, cells, 3) snapped to the lowest Sobel
// magnitude of lab (V, H, W, 3) among each centre and its 8 neighbours.
extern "C" int edge_snap_launch(const float* lab, const float* center, const float* color, float* center_out,
                                float* color_out, int V, int H, int W, int cells, void* stream) {
  const long long n = (long long)V * cells;
  if (V < 0 || H < 0 || W < 0 || cells < 0 || too_many_blocks(n, kSnapThreads)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (H == 0 || W == 0) return (int)cudaErrorInvalidValue;
  edge_snap_kernel<<<blocks_of(n, kSnapThreads), kSnapThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lab, center, color, center_out, color_out, V, H, W, cells);
  return (int)cudaGetLastError();
}
