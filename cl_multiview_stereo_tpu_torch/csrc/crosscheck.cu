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
// Both take a block a run of 128 pixels of one row, so a warp's loads of a
// map at its own pixels, and its stores of an output row, are one 128-byte
// line each.
//
// fuse_warp: for each reference view r, from r's own disparity m, the
// probe chain over the source views i in index order (i = r skipped, as
// the plain form's mask skips it), each probe shifted by the evolving
// maximum:
//   xp = x - cl_round(m * dx),  yp = y - cl_round((bl * m) * dy)
// with (dx, dy) the camera-grid delta r - i, and m takes the probed value
// where it lies in the view and m < it.  Each probe waits on the last (its
// address depends on m), so a thread runs the chains of up to three
// reference views at kWarpRows rows side by side, their loads in flight
// together (a divisor of the view count where 2 or 3 is one; the grid's
// z dimension takes the groups of views).  A coordinate is NaN only where
// m or bl * m is not finite (NaN, or inf x 0 for a delta of 0): the plain
// form reads such a coordinate as 0.  A chain's m turns so only by starting
// so or by taking such a probe, so a thread flag sends a thread through the
// exact steps (float coordinates, nan_to_zero) only from the step after one
// of its chains did.  Every other probe takes its coordinates with no NaN
// test and no float-to-int conversion (round_mag: integer coordinates, the
// bounds as unsigned compares).  Offsets are 32-bit where V x H x W < 2^31
// (the Index template).  Bound: the bytes (the map read once, the warped
// maps written once), below what the chains' latency and their 30-odd
// instructions a probe take.
//
// fuse_vote: candidate i is the warped map of view i at the pixel, the same
// for every reference view r.  The plain form walks them in view order and
// takes a candidate when d != 0, its stability >= 0 and (best == 0 or
// best < d).  Its stability is
//   vote 1: for each view j with proj[j] != 0: -1 if |proj[j] - d| > fuse,
//           else +1 (NaN compares false: +1);
//   vote 2: for each view j, the unwarped map j at
//           (x - cl_round(d * (jx - rx)), y - cl_round((bl * d) * (jy - ry)))
//           where that lies in the view: -1 if |map - d| > fuse, +1 if
//           |map - d| < fuse, 0 on equality or NaN.
// The votes are integers, so the sum is exact in any order (the plain form
// adds them in float32, where every partial sum is a small integer), and
// only its sign matters: vote 2 stops as soon as the lookups left cannot
// change it (stability - left >= 0, or stability + left < 0).
//
// The kernel takes a thread a pixel for all the launch's reference views.
// It loads the V candidates once and walks them in descending order, each
// distinct value once, for all those views at once: vote 1 once a value
// (it does not depend on r), vote 2 for each r still open, and r takes the
// first value whose stability is >= 0, or 0 when none has.  That is the
// plain form's result:
//  - With no NaN among the candidates, the view-order walk ends with the
//    largest valid candidate (d != 0, stability >= 0), or 0 if none is
//    valid.  Its first take sets best to a valid candidate, which is != 0;
//    from then on best == 0 is false, so it takes exactly the valid
//    candidates above best, and best is the running maximum of the valid
//    ones.  `<` orders every value but NaN totally, +-inf included.
//  - A stability depends on the candidate's value, r and the maps, not on
//    its view: equal values have equal stabilities, so each distinct value
//    is scored once (two equal values other than +-0 have the same bits,
//    and 0 and -0 are never candidates).
//  - A NaN candidate is taken exactly when best == 0 (best < NaN is
//    false), and nothing replaces it (best == 0 and best < d are both false
//    for best = NaN): the result is NaN iff the first valid candidate in
//    view order is NaN, which an order by value cannot tell.  So a pixel
//    whose candidates hold a NaN, a test independent of r, runs the
//    view-order walk for each r as the plain form does.
// A warp walks its 32 pixels in rounds, one value a pixel a round, and
// shares the round's vote-2 work, one (pixel, open view) a task, out over
// its 32 lanes through a queue in shared memory: a pixel's lookups do not
// wait on the lanes whose pixels need none.  Reference views are taken 32
// at a time (a mask of those still open).  A lookup's coordinates take the
// warp's integer path where d and bl * d are finite.  Bound: the operations
// of the values scored and the lookups made, by whichever of the two walks
// needs fewer on this run's data (tools/roofline.vote_counts); the bytes
// near them: the two maps read once, the output written once.
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

#include <cfloat>
#include <type_traits>

namespace {

constexpr int kThreads = 128;     // pixels of a row a block
constexpr int kMaxGridY = 65535;  // rows a grid's y dimension holds
constexpr int kWarpRows = 2;      // fuse_warp: rows a thread
constexpr int kOpen = 32;         // fuse_vote: reference views a pass (a mask's bits)
constexpr int kWarps = kThreads / 32;

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

template <typename Index>
__device__ __forceinline__ Index offset(float xf, float yf, int W) {
  return (Index)(int)yf * W + (int)xf;
}

// whether |v| is finite (false for NaN)
__device__ __forceinline__ bool finite(float v) { return fabsf(v) <= FLT_MAX; }

// floor(|t| + 0.5) as an int: exact where |t| + 0.5 < 2^23 (the add
// rounded down onto the integer grid of [2^23, 2^24)), else >= 2^23, inf
// too.  So x - copysign(round_mag(t), t) is x - cl_round(t) wherever that
// lies in a view of fewer than 2^23 columns, and outside it elsewhere, with
// no float-to-int conversion.  NaN is not taken.
__device__ __forceinline__ int round_mag(float t) {
  return __float_as_int(__fadd_rd(__fadd_rn(fabsf(t), 0.5f), 8388608.0f)) - 0x4B000000;
}

// The element offset in an H x W view of pixel (x, y) shifted by
// -cl_round(tx), -cl_round(ty), and whether it lies in the view.  kExact
// follows _probe's NaN rule on float coordinates; without it tx and ty must
// not be NaN and H, W must be below 2^23 (integer coordinates).
template <bool kExact, typename Index>
__device__ __forceinline__ bool shifted(int x, int y, float tx, float ty, int H, int W, Index& off) {
  if (kExact) {
    const float xf = nan_to_zero(__fsub_rn((float)x, cl_round(tx)));
    const float yf = nan_to_zero(__fsub_rn((float)y, cl_round(ty)));
    const bool in = in_view(xf, yf, H, W);
    off = in ? offset<Index>(xf, yf, W) : 0;  // no conversion of a float outside the view
    return in;
  }
  const int fx = round_mag(tx), fy = round_mag(ty);
  const int xi = tx < 0.0f ? x + fx : x - fx, yi = ty < 0.0f ? y + fy : y - fy;
  // unsigned, so a coordinate outside the view (never read) wraps instead of overflowing
  using U = typename std::make_unsigned<Index>::type;
  off = (Index)((U)yi * (U)W + (U)xi);
  return (unsigned)xi < (unsigned)W && (unsigned)yi < (unsigned)H;
}

// images this wide or high take the exact (float) coordinates throughout
__device__ __forceinline__ bool huge(int H, int W) { return H >= (1 << 23) || W >= (1 << 23); }

// One step of a thread's chains over source view i: each live chain probes
// the map `plane` and takes what beats its m.  Without kExact every chain
// must have m and bl * m finite; sets `exact` once a chain takes a value
// whose bl * m is not.
template <bool kExact, int kChains, typename Index>
__device__ __forceinline__ void warp_step(const float* __restrict__ plane, int i, float ixf, float iyf, int H,
                                          int W, float bl, int x, const int (&rv)[kChains],
                                          const float (&rxf)[kChains], const float (&ryf)[kChains],
                                          const int (&py)[kChains], float (&m)[kChains], float (&blm)[kChains],
                                          bool& exact) {
  bool in[kChains];
  float val[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    Index off;
    in[c] = shifted<kExact, Index>(x, py[c], __fmul_rn(m[c], __fsub_rn(rxf[c], ixf)),
                                   __fmul_rn(blm[c], __fsub_rn(ryf[c], iyf)), H, W, off) &&
            rv[c] != i;
    val[c] = in[c] ? __ldg(plane + off) : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    if (in[c] && m[c] < val[c]) {
      m[c] = val[c];
      blm[c] = __fmul_rn(bl, val[c]);
      if (!kExact) exact |= !finite(blm[c]);
    }
  }
}

// Grid (row blocks of kThreads pixels, runs of kRows rows, groups of kViews
// reference views); a run past the grid's y dimension is taken by the block
// gridDim.y runs above it.  Chain c of a thread is view c % kViews of its
// group at row c / kViews of its run; a chain past the group or the image
// is dead: it never probes (its row lies far above the view) and writes
// nothing.
template <int kRows, int kViews, typename Index>
__global__ void __launch_bounds__(kThreads) fuse_warp_kernel(
    const float* __restrict__ disp,  // (V, H, W)
    float* __restrict__ out,         // (nv, H, W)
    int V, int H, int W, int v0, int nv, int aw, float bl) {
  constexpr int kChains = kRows * kViews;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W) return;
  const Index hw = (Index)H * W;
  const int g0 = blockIdx.z * kViews;  // the group's first view, from v0
  const int rx0 = (v0 + g0) % aw, ry0 = (v0 + g0) / aw;
  for (int y0 = kRows * blockIdx.y; y0 < H; y0 += kRows * gridDim.y) {
    int rv[kChains], py[kChains];
    float rxf[kChains], ryf[kChains], m[kChains], blm[kChains];
    bool exact = huge(H, W);
    int rx = rx0, ry = ry0;
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const int k = c % kViews, yy = c / kViews;
      const bool live = g0 + k < nv && y0 + yy < H;
      rv[c] = live ? v0 + g0 + k : -1;
      rxf[c] = (float)rx, ryf[c] = (float)ry;
      py[c] = live ? y0 + yy : -(1 << 30);
      m[c] = live ? __ldg(disp + (Index)(v0 + g0 + k) * hw + (Index)(y0 + yy) * W + x) : 0.0f;
      blm[c] = __fmul_rn(bl, m[c]);
      exact |= !finite(blm[c]);
      if (k == kViews - 1) rx = rx0, ry = ry0;
      else if (++rx == aw) rx = 0, ++ry;
    }
    int ix = 0, iy = 0;
    const float* plane = disp;
#pragma unroll 1
    for (int i = 0; i < V; ++i, plane += hw) {
      const float ixf = (float)ix, iyf = (float)iy;
      if (exact)
        warp_step<true, kChains, Index>(plane, i, ixf, iyf, H, W, bl, x, rv, rxf, ryf, py, m, blm, exact);
      else
        warp_step<false, kChains, Index>(plane, i, ixf, iyf, H, W, bl, x, rv, rxf, ryf, py, m, blm, exact);
      if (++ix == aw) ix = 0, ++iy;
    }
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      if (rv[c] >= 0) out[(Index)(g0 + c % kViews) * hw + (Index)(y0 + c / kViews) * W + x] = m[c];
  }
}

// The V candidates of a pixel and the walks' scans over them: kV > 0 holds
// exactly kV in registers (its loops unrolled, so each index is fixed),
// kV == 0 reads any V from the warped maps (L1 hits after the first pass;
// its loops rolled, to keep its registers few).
template <int kV, typename Index>
struct Candidates {
  float c[kV];
  __device__ __forceinline__ Candidates(const float* __restrict__ at, Index hw, int) {
#pragma unroll
    for (int i = 0; i < kV; ++i) c[i] = __ldg(at + i * hw);
  }
  __device__ __forceinline__ int size() const { return kV; }
  __device__ __forceinline__ bool any_nan() const {
    bool nan = false;
#pragma unroll
    for (int i = 0; i < kV; ++i) nan |= isnan(c[i]);
    return nan;
  }
  // vote 1 of candidate value d over the warped maps at the pixel
  __device__ __forceinline__ int vote1(float d, float fuse) const {
    int stability = 0;
#pragma unroll
    for (int j = 0; j < kV; ++j)
      if (c[j] != 0.0f) stability += fabsf(__fsub_rn(c[j], d)) > fuse ? -1 : 1;
    return stability;
  }
  // the largest nonzero candidate below `prev` (any, for a NaN prev): the
  // candidates hold no NaN, so !(c >= prev) is c < prev
  __device__ __forceinline__ bool next(float prev, float& d) const {
    bool found = false;
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (c[i] != 0.0f && !(c[i] >= prev) && (!found || d < c[i])) d = c[i], found = true;
    return found;
  }
};

template <typename Index>
struct Candidates<0, Index> {
  const float* __restrict__ at;
  Index hw;
  int n;
  __device__ __forceinline__ Candidates(const float* __restrict__ a, Index h, int V) : at(a), hw(h), n(V) {}
  __device__ __forceinline__ int size() const { return n; }
  __device__ __forceinline__ float operator[](int i) const { return __ldg(at + i * hw); }
  __device__ __forceinline__ bool any_nan() const {
    bool nan = false;
#pragma unroll 1
    for (int i = 0; i < n; ++i) nan |= isnan((*this)[i]);
    return nan;
  }
  __device__ __forceinline__ int vote1(float d, float fuse) const {
    int stability = 0;
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      const float dc = (*this)[j];
      if (dc != 0.0f) stability += fabsf(__fsub_rn(dc, d)) > fuse ? -1 : 1;
    }
    return stability;
  }
  __device__ __forceinline__ bool next(float prev, float& d) const {
    bool found = false;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const float ci = (*this)[i];
      if (ci != 0.0f && !(ci >= prev) && (!found || d < ci)) d = ci, found = true;
    }
    return found;
  }
};

// stability + vote 2 of value d for the reference view at (rx, ry) on the
// camera grid, the lookups in view order while the lookups left could
// change the sign (-left <= stability < left).  Without kExact, d and
// bl * d must be finite.
template <bool kExact, typename Index>
__device__ __forceinline__ int vote2(int stability, const float* __restrict__ disp, Index hw, int V, int H, int W,
                                     int aw, int x, int y, float rx, float ry, float d, float bld, float fuse) {
  float jx = 0.0f, jy = 0.0f;
  const float awf = (float)aw;
  const float* plane = disp;
#pragma unroll 1
  for (int left = V; (unsigned)(stability + left) < (unsigned)(2 * left); --left, plane += hw) {
    Index off;
    if (shifted<kExact, Index>(x, y, __fmul_rn(d, __fsub_rn(jx, rx)), __fmul_rn(bld, __fsub_rn(jy, ry)), H, W,
                               off)) {
      const float diff = fabsf(__fsub_rn(__ldg(plane + off), d));
      stability += (diff > fuse ? -1 : 0) + (diff < fuse ? 1 : 0);
    }
    jx = __fadd_rn(jx, 1.0f);
    if (jx == awf) jx = 0.0f, jy = __fadd_rn(jy, 1.0f);
  }
  return stability;
}

// Grid (row blocks of kThreads pixels, rows); a row past the grid's y
// dimension is taken by the block gridDim.y rows above it.  kV: the views
// (0: any, read from memory).  A warp walks its 32 pixels' values in
// rounds: each lane picks its pixel's next value and scores vote 1, then the
// (pixel, open view) pairs that need vote 2 go into the warp's queue, and
// the 32 lanes share them out, so a lane whose pixel needs no lookup this
// round runs another pixel's.
template <int kV, typename Index>
__global__ void __launch_bounds__(kThreads, 1) fuse_vote_kernel(
    const float* __restrict__ proj,  // (V, H, W) warped maps
    const float* __restrict__ disp,  // (V, H, W) unwarped maps
    float* __restrict__ out,         // (nv, H, W)
    int V, int H, int W, int v0, int nv, int aw, float bl, float fuse) {
  __shared__ unsigned short queue[kWarps][32 * kOpen];  // a round's tasks: lane << 5 | view
  __shared__ float value[kWarps][32];                   // each lane's value this round
  __shared__ int score1[kWarps][32];                    // its vote 1
  __shared__ unsigned taken[kWarps][32];                // the views whose stability it won
  __shared__ float cam[kWarps][2][kOpen];               // the pass's views on the camera grid
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kThreads + w * 32;  // the warp's first column
  if (x0 >= W) return;                            // the whole warp
  const int x = x0 + lane;
  const bool live = x < W;
  const Index hw = (Index)H * W;
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    const Index p = (Index)y * W + (live ? x : W - 1);
    const Candidates<kV, Index> c(proj + p, hw, V);
    const bool nan = live && c.any_nan();
    for (int r0 = 0; r0 < nv; r0 += kOpen) {
      const int nr = nv - r0 < kOpen ? nv - r0 : kOpen;
      const int rx0 = (v0 + r0) % aw, ry0 = (v0 + r0) / aw;
      float* const o = out + (Index)r0 * hw + p;
      __syncwarp();
      if (lane < nr) {
        cam[w][0][lane] = (float)((v0 + r0 + lane) % aw);
        cam[w][1][lane] = (float)((v0 + r0 + lane) / aw);
      }
      __syncwarp();
      if (nan) {
        // the plain form's view-order walk for each r (candidates from
        // memory: a rare path kept small)
        const Candidates<0, Index> cm(proj + p, hw, V);
        int rx = rx0, ry = ry0;
        for (int k = 0; k < nr; ++k) {
          float best = 0.0f;
#pragma unroll 1
          for (int i = 0; i < V; ++i) {
            const float d = cm[i];
            if (!(d != 0.0f && (best == 0.0f || best < d))) continue;  // refused whatever its stability
            const int s = vote2<true, Index>(cm.vote1(d, fuse), disp, hw, V, H, W, aw, x, y, (float)rx,
                                             (float)ry, d, __fmul_rn(bl, d), fuse);
            if (s >= 0) best = d;
          }
          o[k * hw] = best;
          if (++rx == aw) rx = 0, ++ry;
        }
      }
      unsigned open = live && !nan ? (nr == kOpen ? ~0u : (1u << nr) - 1u) : 0u;
      float d = __int_as_float(0x7fffffff);  // NaN: the first value may be any
      while (__any_sync(~0u, open != 0u)) {
        unsigned tasks = 0u;
        if (open) {
          // the next value: the largest nonzero candidate below the last
          if (!c.next(d, d)) {
            for (unsigned t = open; t; t &= t - 1) o[(__ffs(t) - 1) * hw] = 0.0f;
            open = 0u;
          } else {
            const int s1 = c.vote1(d, fuse);
            if (s1 - c.size() >= 0) {  // taken by every r whatever vote 2 gives
              for (unsigned t = open; t; t &= t - 1) o[(__ffs(t) - 1) * hw] = d;
              open = 0u;
            } else if (s1 + c.size() >= 0) {  // else refused by every r
              tasks = open;
              value[w][lane] = d, score1[w][lane] = s1;
            }
          }
        }
        taken[w][lane] = 0u;
        // the queue: each lane's tasks after those of the lanes below it
        const int n = __popc(tasks);
        int end = n;
#pragma unroll
        for (int step = 1; step < 32; step <<= 1) {
          const int below = __shfl_up_sync(~0u, end, step);
          if (lane >= step) end += below;
        }
        const int total = __shfl_sync(~0u, end, 31);
        for (int q = end - n; tasks; tasks &= tasks - 1, ++q)
          queue[w][q] = (unsigned short)(lane << 5 | (__ffs(tasks) - 1));
        __syncwarp();
        for (int q = lane; q < total; q += 32) {
          const int owner = queue[w][q] >> 5, k = queue[w][q] & 31;
          const float dq = value[w][owner], bld = __fmul_rn(bl, dq);
          const int s1 = score1[w][owner];
          const float rx = cam[w][0][k], ry = cam[w][1][k];
          const int s = !(finite(dq) && finite(bld)) || huge(H, W)
                            ? vote2<true, Index>(s1, disp, hw, V, H, W, aw, x0 + owner, y, rx, ry, dq, bld, fuse)
                            : vote2<false, Index>(s1, disp, hw, V, H, W, aw, x0 + owner, y, rx, ry, dq, bld, fuse);
          if (s >= 0) atomicOr(&taken[w][owner], 1u << k);
        }
        __syncwarp();
        const unsigned won = taken[w][lane];
        for (unsigned t = won; t; t &= t - 1) o[(__ffs(t) - 1) * hw] = d;
        open &= ~won;
      }
    }
  }
}

// The shapes a launch takes: a view range inside V views on a grid of
// aw columns, no more views than a grid's z dimension holds.
bool bad_shape(int V, int H, int W, int v0, int nv, int aw) {
  return V < 0 || H < 0 || W < 0 || aw < 1 || v0 < 0 || nv < 0 || (long long)v0 + nv > V || nv > 65535;
}

// 32-bit offsets reach every element of the maps
bool fits_int(int V, int H, int W) { return (long long)V * H * W < (1LL << 31); }

// the grid of a launch over `groups` view groups of H rows, `rows` a thread
dim3 grid_of(int H, int W, int groups, int rows) {
  const int y = (H + rows - 1) / rows;
  return dim3((unsigned int)((W + kThreads - 1) / kThreads), (unsigned int)(y < kMaxGridY ? y : kMaxGridY),
              (unsigned int)groups);
}

template <int kRows, int kViews, typename Index>
void warp_launch(const float* disp, float* out, int V, int H, int W, int v0, int nv, int aw, float bl,
                 cudaStream_t st) {
  fuse_warp_kernel<kRows, kViews, Index>
      <<<grid_of(H, W, (nv + kViews - 1) / kViews, kRows), kThreads, 0, st>>>(disp, out, V, H, W, v0, nv, aw, bl);
}

// kWarpRows rows and up to three reference views a thread, the views a
// divisor of nv where one of 2 and 3 is (a 1- or 2-view group runs a
// rank's one or two views in under 0.72x the time of a 3-view group with
// its dead chains, on an H100: PERF.md)
template <typename Index>
void warp_views(const float* disp, float* out, int V, int H, int W, int v0, int nv, int aw, float bl,
                cudaStream_t st) {
  if (nv == 1)
    warp_launch<kWarpRows, 1, Index>(disp, out, V, H, W, v0, nv, aw, bl, st);
  else if (nv % 3 != 0 && nv % 2 == 0)
    warp_launch<kWarpRows, 2, Index>(disp, out, V, H, W, v0, nv, aw, bl, st);
  else
    warp_launch<kWarpRows, 3, Index>(disp, out, V, H, W, v0, nv, aw, bl, st);
}

template <int kV, typename Index>
void vote_launch(const float* proj, const float* disp, float* out, int V, int H, int W, int v0, int nv, int aw,
                 float bl, float fuse, cudaStream_t st) {
  fuse_vote_kernel<kV, Index><<<grid_of(H, W, 1, 1), kThreads, 0, st>>>(proj, disp, out, V, H, W, v0, nv, aw, bl,
                                                                        fuse);
}

template <typename Index>
void vote_views(const float* proj, const float* disp, float* out, int V, int H, int W, int v0, int nv, int aw,
                float bl, float fuse, cudaStream_t st) {
  // the reference 3 x 3 camera array: its candidates in registers (0.84x
  // the time of reading them from memory, on an H100: PERF.md)
  if (V == 9)
    vote_launch<9, Index>(proj, disp, out, V, H, W, v0, nv, aw, bl, fuse, st);
  else
    vote_launch<0, Index>(proj, disp, out, V, H, W, v0, nv, aw, bl, fuse, st);
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
  if (fits_int(V, H, W))
    warp_views<int>(disp, out, V, H, W, v0, nv, aw, bl, st);
  else
    warp_views<long long>(disp, out, V, H, W, v0, nv, aw, bl, st);
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
  if (fits_int(V, H, W))
    vote_views<int>(proj, disp, out, V, H, W, v0, nv, aw, bl, fuse, st);
  else
    vote_views<long long>(proj, disp, out, V, H, W, v0, nv, aw, bl, fuse, st);
  return (int)cudaGetLastError();
}
