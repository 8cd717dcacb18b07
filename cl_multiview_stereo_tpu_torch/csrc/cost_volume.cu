// Superpixel depth-init cost volume for Hopper (sm_90a).
//
// Replaces the TPU kernel cl_multiview_stereo_tpu/ops/cost_volume.py:
// _win_extract_kernel, together with the aligned block-pair gather around
// it (ops/pallas/consistency.py:_strip_gather) and the dense shift-plane
// sweep that superpixel_cost_volume_strips uses for the diagonal deltas.
// On the TPU those exist because Mosaic's lane gather cannot cross 128
// lanes and partial-row gathers fall onto a scalar DMA path.  It computes
//
//   out[v - v0, d, my, mx] = min over valid deltas g of
//                       sum over 25 samples (i outer, j inner) of
//                       ok ? |dL| + |da| + |db| : 30
//
// for the reference views v0 <= v < v0 + nv (all V views by default, a
// rank's own views in the view-sharded pipeline, parallel/sharded_pipeline),
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
// are summed one at a time from 0 in the JAX order, channels L, a, b; the
// min over deltas is exact, so the output is bitwise the plain twin's
// (ops/cost_volume.py:cost_volume_reference).  Only the order in which the
// card visits the work is this file's own.
//
// What bounds it on the card.  The work is about 1e9 sample terms at
// 9 x 1080p x 31 hypotheses (40 view pairs, 25 samples per superpixel),
// each three neighbour reads, three reference reads and nine f32
// operations; the unique bytes (the Lab images, 224 MB) are a tenth of that
// in time.  So the kernel is bound by how fast it feeds those reads, and
// the design keeps every one of them on chip:
//
// * One block owns one view and a tile of 8 x 8 superpixel cells, four
//   threads per cell, and loops over the valid deltas and the whole ladder
//   itself.  It stages the tile's reference sample box once, as it stages a
//   neighbour box below, and the cell's four threads pick its 25 reference
//   Lab values from it into shared memory; each thread keeps the positions
//   and in-image flags in registers.  Nothing is reloaded from device
//   memory per (hypothesis, delta).
// * For one delta and one chunk of 16 hypotheses the neighbour pixels the
//   tile can read lie in one box: the block's own sample box (from its
//   own centres and steps: SLIC centres drift, so no static box holds)
//   shifted by the chunk's range of ceil(d*gx), ceil(bl*d*gy), cut at the
//   image edge by the same clamp as the reads.  The block stages that box
//   in dynamic shared memory, each row segment by 16-byte cp.async copies
//   from the (H, W, 3) image as it lies (coalesced, no de-interleave), so
//   every (hypothesis, sample) read is a shared-memory read.  A box taller
//   than the buffer is staged from its top, and a read below the staged
//   rows reads device memory, with the same arithmetic.
// * A round whose reads all lie in the image, a pixel clear of its far
//   edges, on a tile whose samples all lie in the image, needs no clamp and
//   no validity test (interior_sums); the others test every sample
//   (sample_sum).  Which one runs is decided per round for the whole block,
//   so no warp diverges.
// * The band buffer (96,384 B) and the colours (19,200 B) leave room for
//   two blocks on an SM, and __launch_bounds__(256, 2) caps the registers
//   at 128: one block stages while the other computes.  The four threads
//   of a cell take neighbouring hypotheses, so their reads fall on
//   neighbouring pixels (three floats apart: distinct banks), and the row
//   pitch, 4 times an odd number, spreads vertical neighbours over banks.
// * Blocks are numbered view-fastest, so the blocks in flight cover a few
//   tiles of every view, and the neighbour images' boxes they stage
//   overlap in the 50 MB L2: the images come from HBM about once.
// * Stores stay coalesced along mx into (V, D, Mh, Mw).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kOobPenalty = 30.0f;
constexpr float kBig = 1.0e6f;
constexpr int kTileX = 8;   // cells per block along mx
constexpr int kTileY = 8;   // cells per block along my
constexpr int kSub = 4;     // threads per cell
constexpr int kPerThread = 4;  // hypotheses per thread per chunk
constexpr int kChunk = kSub * kPerThread;  // 16
constexpr int kThreads = kTileX * kTileY * kSub;  // 256
constexpr int kWarps = kThreads / 32;
constexpr int kCells = kTileX * kTileY;
constexpr int kRef = 75;  // floats of a cell's 25 reference Lab values
constexpr int kBandFloats = 24096;  // 96,384 B: two blocks per SM
constexpr int kBandBytes = kBandFloats * 4;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Box {
  int x0, y0;   // image position of the staged box's first pixel
  int bw;       // staged columns
  int rows;     // staged rows (0: nothing staged)
  int pitch;    // floats between staged rows: a multiple of 4, pitch / 4 odd
  int mis0;     // floats from a 16-byte boundary to the box's first pixel
  int all;      // 1: the whole box is staged
  int interior; // 1: besides, no read is clamped and every sample is valid
};

// The sums of an interior round, for the thread's kPerThread hypotheses at
// once.  Every sample of every cell of the tile lies in the image and every
// read x - ceil(d*gx) of the round lies in [0, W - 2] (and likewise in y), so no read
// is clamped and every sample is valid: x - ceil(d*gx) >= 0 gives
// x - d*gx >= 0 > -1, and x - ceil(d*gx) <= W - 2 gives x - d*gx < W - 1,
// which the f32 difference cannot round up to W.  The sums need no test.
// Each of them still runs i outer, j inner, from 0; the hypotheses only
// share each sample row's 15 reference values, read once from shared memory
// into registers.
__device__ __forceinline__ void interior_sums(
    const float* ref, const int (&xr)[5], const int (&yr)[5], const float (&cxs)[kPerThread],
    const float (&cys)[kPerThread], int W, const float* band, const Box& b,
    float (&acc)[kPerThread]) {
  int col[kPerThread][5], row[kPerThread][5];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int shx = (int)ceilf(cxs[k]);
    const int shy = (int)ceilf(cys[k]);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      col[k][i] = 3 * (xr[i] - shx - b.x0);
      const int y = yr[i] - shy - b.y0;
      row[k][i] = y * b.pitch + ((b.mis0 + y * 3 * W) & 3);
    }
    acc[k] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    float r[15];
#pragma unroll
    for (int n = 0; n < 15; ++n) r[n] = ref[15 * i + n];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const float* q = band + row[k][j] + col[k][i];
        acc[k] = __fadd_rn(acc[k], __fadd_rn(__fadd_rn(fabsf(__fadd_rn(r[3 * j], -q[0])),
                                                       fabsf(__fadd_rn(r[3 * j + 1], -q[1]))),
                                             fabsf(__fadd_rn(r[3 * j + 2], -q[2]))));
      }
    }
  }
}

// One hypothesis' cost against one neighbour, every sample tested: the
// 25-sample sum, i outer, j inner, from 0.  ``cxs``/``cys`` are the f32
// products d*gx and (bl*d)*gy.  A valid read below the staged rows goes to
// device memory.  ``ref`` is read volatile: cached in registers, the colours
// would crowd out the per-sample offsets, which the compiler then
// recomputed for every sample.
__device__ __forceinline__ float sample_sum(
    const volatile float* ref, const int (&xr)[5], const int (&yr)[5],
    unsigned xin, unsigned yin, float cxs, float cys, int H, int W,
    const float* band, const Box& b, const float* nb_img) {
  const int shx = (int)ceilf(cxs);
  const int shy = (int)ceilf(cys);
  int xo[5], yo[5];
  unsigned okx = 0, oky = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float px = __fadd_rn((float)xr[i], -cxs);
    if (((xin >> i) & 1u) && px > -1.0f && px < (float)W) okx |= 1u << i;
    xo[i] = clampi(xr[i] - shx, 0, W - 1) - b.x0;
    const float py = __fadd_rn((float)yr[i], -cys);
    if (((yin >> i) & 1u) && py > -1.0f && py < (float)H) oky |= 1u << i;
    yo[i] = clampi(yr[i] - shy, 0, H - 1) - b.y0;
    xo[i] *= 3;
  }
  int row[5];  // band offset of each sample row's first staged pixel
#pragma unroll
  for (int j = 0; j < 5; ++j) row[j] = yo[j] * b.pitch + ((b.mis0 + yo[j] * 3 * W) & 3);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const bool ok = ((okx >> i) & 1u) && ((oky >> j) & 1u);
      float q0, q1, q2;
      if (ok && (unsigned)yo[j] < (unsigned)b.rows) {
        const float* q = band + row[j] + xo[i];
        q0 = q[0];
        q1 = q[1];
        q2 = q[2];
      } else if (ok) {  // below the staged rows: device memory
        const float* q = nb_img + ((size_t)(yo[j] + b.y0) * W + b.x0) * 3 + xo[i];
        q0 = q[0];
        q1 = q[1];
        q2 = q[2];
      } else {
        q0 = q1 = q2 = 0.0f;
      }
      const volatile float* r = ref + 3 * (5 * i + j);
      const float sad = __fadd_rn(__fadd_rn(fabsf(__fadd_rn(r[0], -q0)),
                                            fabsf(__fadd_rn(r[1], -q1))),
                                  fabsf(__fadd_rn(r[2], -q2)));
      acc = __fadd_rn(acc, ok ? sad : kOobPenalty);
    }
  }
  return acc;
}

// The box [x0, x1] x [y0, y1] of image ``img`` as the band holds it, cut to
// the buffer's rows.
__device__ __forceinline__ Box make_box(int x0, int x1, int y0, int y1, const float* img, int W) {
  Box b{x0, y0, x1 - x0 + 1, 0, 4, 0, 0, 0};
  b.pitch = 4 * (((3 * b.bw + 6) >> 2) | 1);
  b.rows = min(y1 - y0 + 1, kBandFloats / b.pitch);
  b.all = b.rows == y1 - y0 + 1;
  b.mis0 = (int)((reinterpret_cast<uintptr_t>(img + ((size_t)y0 * W + x0) * 3) >> 2) & 3);
  return b;
}

// Stage box ``b`` of image ``img`` into the band: rows over warps; each row
// segment, from the 16-byte boundary at or before its first pixel, in
// 16-byte copies over lanes (4-byte copies for a chunk that reaches past the
// tensor's ends).  Returns when this thread's copies have landed; the caller
// synchronises the block.
__device__ __forceinline__ void stage_box(float* band, const float* img, const Box& b, int W,
                                          const float* lab, const float* lab_end) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < b.rows; r += kWarps) {
    const float* seg = img + ((size_t)(b.y0 + r) * W + b.x0) * 3;
    const int mis = (int)((reinterpret_cast<uintptr_t>(seg) >> 2) & 3);
    const float* src = seg - mis;
    const int chunks = (mis + 3 * b.bw + 3) >> 2;
    float* dst = band + r * b.pitch;
    for (int m = lane; m < chunks; m += 32) {
      const float* g = src + 4 * m;
      if (g >= lab && g + 4 <= lab_end) {
        cp_async16(dst + 4 * m, g);
      } else {
        for (int t = 0; t < 4; ++t)
          if (g + t >= lab && g + t < lab_end) cp_async4(dst + 4 * m + t, g + t);
      }
    }
  }
  cp_async_wait_all();
}

__global__ void __launch_bounds__(kThreads, 2) cost_volume_kernel(
    const float* __restrict__ lab,      // (V, H, W, 3)
    const float* __restrict__ centers,  // (V, Mh, Mw, 2) (x, y)
    const float* __restrict__ step,     // (V, Mh, Mw, 2) (step_x, step_y)
    const float* __restrict__ disp,     // (D,)
    float* __restrict__ out,            // (nv, D, Mh, Mw)
    int V, int H, int W, int Mh, int Mw, int D,
    int array_width, int neib_hor, int neib_ver, float bl_ratio, int v0, int nv) {
  extern __shared__ float4 band_v[];  // 16-byte aligned for cp.async
  float* band = reinterpret_cast<float*>(band_v);
  __shared__ float s_ref[kCells][kRef];  // each cell's reference colours
  __shared__ int s_lim[4];  // xmin, xmax, ymin, ymax of the tile's samples
  __shared__ Box s_box;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles_x = (Mw + kTileX - 1) / kTileX;
  const int cell = tid / kSub;
  const int sub = tid % kSub;
  float* ref = s_ref[cell];
  const size_t plane_hw = (size_t)H * W;
  const float* lab_end = lab + (size_t)V * plane_hw * 3;
  const int array_height = V / array_width;

  // one (tile, view) task per block, view fastest, over the reference
  // views v0 .. v0 + nv - 1
  const int v = v0 + (int)(blockIdx.x % nv);
  const int tile = blockIdx.x / nv;
  const int mx = (tile % tiles_x) * kTileX + cell % kTileX;
  const int my = (tile / tiles_x) * kTileY + cell / kTileX;
  const bool active = mx < Mw && my < Mh;
  const float* ref_img = lab + (size_t)v * plane_hw * 3;

  // the cell's samples: positions and in-image flags
  int xr[5], yr[5];
  unsigned xin = 0, yin = 0;  // bit i: sample column / row i in the image
  int xmin = INT_MAX, xmax = INT_MIN, ymin = INT_MAX, ymax = INT_MIN;
  if (active) {
    const size_t c = ((size_t)v * Mh + my) * Mw + mx;
    const float cx = centers[2 * c];
    const float cy = centers[2 * c + 1];
    const float sx = step[2 * c];
    const float sy = step[2 * c + 1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      xr[i] = (int)__fadd_rn(cx, __fmul_rn((float)(i - 2), sx));
      yr[i] = (int)__fadd_rn(cy, __fmul_rn((float)(i - 2), sy));
      if (xr[i] >= 0 && xr[i] < W) {
        xin |= 1u << i;
        xmin = min(xmin, xr[i]);
        xmax = max(xmax, xr[i]);
      }
      if (yr[i] >= 0 && yr[i] < H) {
        yin |= 1u << i;
        ymin = min(ymin, yr[i]);
        ymax = max(ymax, yr[i]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 5; ++i) xr[i] = yr[i] = 0;
  }

  // the tile's sample box, from its own centres
  if (tid == 0) {
    s_lim[0] = INT_MAX;
    s_lim[1] = INT_MIN;
    s_lim[2] = INT_MAX;
    s_lim[3] = INT_MIN;
  }
  __syncthreads();
  xmin = __reduce_min_sync(0xffffffffu, xmin);
  xmax = __reduce_max_sync(0xffffffffu, xmax);
  ymin = __reduce_min_sync(0xffffffffu, ymin);
  ymax = __reduce_max_sync(0xffffffffu, ymax);
  if (lane == 0) {
    atomicMin(&s_lim[0], xmin);
    atomicMax(&s_lim[1], xmax);
    atomicMin(&s_lim[2], ymin);
    atomicMax(&s_lim[3], ymax);
  }
  __syncthreads();
  const int bxmin = s_lim[0], bxmax = s_lim[1], bymin = s_lim[2], bymax = s_lim[3];
  // every sample of every cell of the tile lies in the image
  const bool tile_in = __syncthreads_and(!active || (xin == 0x1fu && yin == 0x1fu));

  // the reference colours, once: the sample box of view v staged
  // like a round's box (coalesced), then each cell's 25 samples read from
  // it by the cell's four threads into shared memory
  Box rb{0, 0, 0, 0, 4, 0, 0, 0};
  if (bxmin <= bxmax && bymin <= bymax) {
    rb = make_box(bxmin, bxmax, bymin, bymax, ref_img, W);
    stage_box(band, ref_img, rb, W, lab, lab_end);
  }
  __syncthreads();
  if (active) {
    for (int n = sub; n < 25; n += kSub) {
      const int i = n / 5, j = n % 5;
      float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
      if (((xin >> i) & 1u) && ((yin >> j) & 1u)) {
        const int y = yr[j] - rb.y0;
        const float* q = y < rb.rows
            ? band + y * rb.pitch + ((rb.mis0 + y * 3 * W) & 3) + 3 * (xr[i] - rb.x0)
            : ref_img + ((size_t)yr[j] * W + xr[i]) * 3;  // below the staged rows
        c0 = q[0];
        c1 = q[1];
        c2 = q[2];
      }
      ref[3 * n] = c0;
      ref[3 * n + 1] = c1;
      ref[3 * n + 2] = c2;
    }
  }

  const int zx = v % array_width;
  const int zy = v / array_width;
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    const int d_end = min(D, d0 + kChunk);
    float best[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) best[k] = kBig;

    for (int gx = -neib_hor; gx <= neib_hor; ++gx) {
      for (int gy = -neib_ver; gy <= neib_ver; ++gy) {
        if (gx == 0 && gy == 0) continue;
        if (zx + gx < 0 || zx + gx >= array_width || zy + gy < 0 ||
            zy + gy >= array_height)
          continue;
        const int nv = v + gy * array_width + gx;
        const float* nb_img = lab + (size_t)nv * plane_hw * 3;
        const float fgx = (float)gx;
        const float fgy = (float)gy;

        __syncthreads();  // the band (and the reference box) is no longer read
        if (warp == 0) {
          // the chunk's range of shifts, one hypothesis per lane
          int shx_lo = INT_MAX, shx_hi = INT_MIN, shy_lo = INT_MAX, shy_hi = INT_MIN;
          if (d0 + lane < d_end) {
            const float dl = disp[d0 + lane];
            const int shx = (int)ceilf(__fmul_rn(dl, fgx));
            const int shy = (int)ceilf(__fmul_rn(__fmul_rn(bl_ratio, dl), fgy));
            shx_lo = shx_hi = shx;
            shy_lo = shy_hi = shy;
          }
          shx_lo = __reduce_min_sync(0xffffffffu, shx_lo);
          shx_hi = __reduce_max_sync(0xffffffffu, shx_hi);
          shy_lo = __reduce_min_sync(0xffffffffu, shy_lo);
          shy_hi = __reduce_max_sync(0xffffffffu, shy_hi);
          if (lane == 0) {
            Box b{0, 0, 0, 0, 4, 0, 0, 0};
            if (bxmin <= bxmax && bymin <= bymax) {
              b = make_box(clampi(bxmin - shx_hi, 0, W - 1), clampi(bxmax - shx_lo, 0, W - 1),
                           clampi(bymin - shy_hi, 0, H - 1), clampi(bymax - shy_lo, 0, H - 1),
                           nb_img, W);
              b.interior = b.all && tile_in && bxmin - shx_hi >= 0 && bxmax - shx_lo <= W - 2 &&
                           bymin - shy_hi >= 0 && bymax - shy_lo <= H - 2;
            }
            s_box = b;
          }
        }
        __syncthreads();
        const Box b = s_box;
        stage_box(band, nb_img, b, W, lab, lab_end);
        __syncthreads();

        // the thread's hypotheses d0 + sub + 4k; past the ladder's end the
        // last one is summed and dropped, so the sums stay branch-free
        float cxs[kPerThread], cys[kPerThread];
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const float dl = disp[min(d0 + sub + kSub * k, d_end - 1)];
          cxs[k] = __fmul_rn(dl, fgx);                        // d * gx
          cys[k] = __fmul_rn(__fmul_rn(bl_ratio, dl), fgy);  // (bl * d) * gy
        }
        float acc[kPerThread];
        if (!active) {
        } else if (b.interior) {
          interior_sums(ref, xr, yr, cxs, cys, W, band, b, acc);
        } else {
#pragma unroll
          for (int k = 0; k < kPerThread; ++k)
            acc[k] = sample_sum(ref, xr, yr, xin, yin, cxs[k], cys[k], H, W, band, b, nb_img);
        }
        if (active) {
#pragma unroll
          for (int k = 0; k < kPerThread; ++k)
            if (d0 + sub + kSub * k < d_end) best[k] = fminf(best[k], acc[k]);
        }
      }
    }

    if (active) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int d = d0 + sub + kSub * k;
        if (d < d_end) out[(((size_t)(v - v0) * D + d) * Mh + my) * Mw + mx] = best[k];
      }
    }
  }
}

// Above 48 KB of dynamic shared memory only after this opt-in; the carveout
// asks for all 228 KB of the SM's shared memory, so that two blocks fit.
cudaError_t configure() {
  const cudaError_t e = cudaFuncSetAttribute(
      cost_volume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBandBytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(cost_volume_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Blocks of the kernel that fit on one SM at once, into ``*blocks``;
// returns the CUDA error (0 on success).
extern "C" int cost_volume_blocks_per_sm(int* blocks) {
  const cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, cost_volume_kernel, kThreads,
                                                            kBandBytes);
}

// Plain C entry point, bound with ctypes.  Launches on ``stream`` and
// returns the first CUDA error (0 on success); it does not synchronise.
// ``lab``, ``centers`` and ``step`` hold all V views; the volume is
// computed for the reference views v0 .. v0 + nv - 1 into ``out``
// (nv, D, Mh, Mw).  The whole volume is v0 = 0, nv = V.
extern "C" int cost_volume_launch(
    const float* lab, const float* centers, const float* step,
    const float* disp, float* out, int V, int H, int W, int Mh, int Mw,
    int D, int array_width, int neib_hor, int neib_ver, float bl_ratio,
    int v0, int nv, void* stream) {
  if (v0 < 0 || nv < 0 || v0 + nv > V) return (int)cudaErrorInvalidValue;
  if ((long long)nv * D * Mh * Mw == 0) return 0;
  const cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  const long long tiles =
      (long long)((Mw + kTileX - 1) / kTileX) * ((Mh + kTileY - 1) / kTileY);
  cost_volume_kernel<<<(unsigned int)(tiles * nv), kThreads, kBandBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      lab, centers, step, disp, out, V, H, W, Mh, Mw, D, array_width, neib_hor, neib_ver,
      bl_ratio, v0, nv);
  return (int)cudaGetLastError();
}
