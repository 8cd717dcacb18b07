// PatchMatch's move chain of one Jacobi sweep for Hopper (sm_90a): the
// update moves' candidate planes, the accept walk over the update moves
// with the ring refits' normals, and the accept walk over the refits.
//
// Replaces the JAX package's cl_multiview_stereo_tpu/ops/refine.py:
// gather_update_moves (:778) and the update_body / refine_body scans of
// _propagate_iteration (:963, :1023), XLA functions, not Pallas; the
// reference ran the chain inside its propagate kernel (clcode.cl:1649-1900).
// The port's plain forms (ops/refine.update_candidates_reference,
// update_phase_reference, refit_phase_reference) take M torch.rolls of a
// 9-wide cell pack, then walk the moves with 4-6 elementwise passes each:
// about 500 launches a sweep.  Here a sweep's chain is three launches.
//
// chain_moves: one thread a (move m, cell (v, row0 + yy, x)) of the rows
//   scored.  (dx, dy) = offs[m]; the neighbour (x + dx, y + dy) is read
//   wrapped around the map, as the plain form's torch.roll reads it, and
//   ok = it lies on the map.  From the neighbour's (cx', cy', L', a', b',
//   d', nx', ny', nz') and the home cell's (cx, cy, L, a, b):
//     d   = ((nx' * (cx' - cx) + ny' * (cy' - cy)) + nz' * d') / nz'
//     n   = (nx', ny', nz')
//     sim = ftz(expf((-(((L - L')^2 + (a - a')^2) + (b - b')^2)) * gamma))
//   gamma comes as float32, as torch's multiply by a Python float rounds it.
//
// chain_update: a warp a tile of 32 cells.  With the scores (sm1, cs1) of
//   the M update moves, in move order: accept = ok && (ftz(cs1 * sm1) >
//   ftz(sm0 * cs0) || greedy && ftz(sm1 * sim) > sm0); an accepted move
//   replaces d, sm, cs and n.  It writes that state, then the 8 ring refit
//   normals of the new d (_RING's order, r2 = (r + 1) % 8):
//     v1 = (dcx[r], dcy[r], ring_d[r] - d), v2 the same at r2,
//     c  = refine._cross(v1, v2), |c| = sqrt((cx*cx + cy*cy) + cz*cz),
//     n_ref[r] = (cx / |c|, cy / |c|, cz / |c|), ok_ref[r] = ok[r] && ok[r2].
//   Layout: a warp walks a tile of kTile = 32 consecutive cells (lane =
//   cell) on its own, kTileWarps tiles a block, with no block barrier.  It
//   puts every load of a chunk of kChunk = 16 moves in flight at once: the
//   scores (sm1, cs1, and sim only under the greedy rules) by 4-byte
//   cp.async into its shared memory, each a 128-byte row of an (M, N)
//   array, their validity into a bit mask, and the cell's ring fields into
//   registers by 16-byte loads (4-byte ones where a base is not 16-byte
//   aligned).  The main path's M is 8-16, one chunk.  Then it walks the
//   moves out of shared memory keeping only (sm0, cs0) and the last
//   accepted move k*: no global load sits inside the walk.  It reads d and
//   n once, from move k* (the bits torch.where copies) or from the input
//   state, and computes the 8 refits from registers, writing each plane of
//   n_ref as 384 contiguous bytes (through shared memory) and of ok_ref as
//   32.  Bound: bytes, about 380 a cell at M = 8; a warp makes two round
//   trips to memory (its loads, then the accepted d and n), and the SM
//   keeps 28 tiles in flight.
//
// chain_refit: one thread a cell.  With the refits' scores, in ring order:
//   accept = ok_ref && (ftz(sm1 * cs1) > ftz(sm0 * cs0) || greedy && sm1 >
//   sm0); an accepted refit replaces sm, cs and n (d stays).
//
// A NaN score fails every compare, as torch's > does; an accepted value is
// copied bit for bit, as torch.where copies it.  Arithmetic: every product,
// sum, quotient and root is a _rn intrinsic, the library is built with
// --fmad=false, exp is the precise expf, and subnormals are flushed by hand
// (ftz) exactly where the plain forms call refine._ftz.  So each kernel is
// bitwise its plain form on the card.
//
// Layout of chain_moves and chain_refit: each thread reads and writes its
// own (move,) cell's entries, so consecutive threads touch consecutive
// cells; the cell maps (7 MB a field set at 9 x 135 x 240) stay in L2 for
// the neighbour reads.

#include <cuda_runtime.h>

namespace {

constexpr float kFltMin = 1.17549435e-38f;  // smallest normal float32
constexpr int kRing = 8;
constexpr int kThreads = 256;
// chain_update: cells a tile (one a lane), tiles a block (one a warp), and
// update moves staged in shared memory at once
constexpr int kTile = 32, kTileWarps = 4, kUpdateThreads = 32 * kTileWarps, kChunk = 16;
static_assert(kChunk <= 32, "a chunk's validity is a 32-bit mask");

__device__ __forceinline__ float ftz(float x) { return fabsf(x) < kFltMin ? 0.0f : x; }

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

__global__ void __launch_bounds__(kThreads) chain_moves_kernel(
    const float* __restrict__ center,  // (V, Mh, Mw, 2)
    const float* __restrict__ color,   // (V, Mh, Mw, 3)
    const float* __restrict__ state_d, // (V, Mh, Mw)
    const float* __restrict__ state_n, // (V, Mh, Mw, 3)
    const int* __restrict__ offs,      // (M, 2) dx, dy
    float* __restrict__ d_c,           // (M, V, rows, Mw)
    float* __restrict__ n_c,           // (M, V, rows, Mw, 3)
    float* __restrict__ sim,           // (M, V, rows, Mw)
    unsigned char* __restrict__ ok,    // (M, V, rows, Mw)
    int M, int V, int Mh, int Mw, int row0, int rows, float gamma) {
  const int N = V * rows * Mw, total = M * N;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    const int m = i / N, c = i - m * N;
    const int x = c % Mw, vr = c / Mw;
    const int y = row0 + vr % rows, v = vr / rows;
    const int tx = x + __ldg(offs + 2 * m), ty = y + __ldg(offs + 2 * m + 1);
    const int home = (v * Mh + y) * Mw + x, src = (v * Mh + wrap(ty, Mh)) * Mw + wrap(tx, Mw);
    const float cx = __ldg(center + 2 * home), cy = __ldg(center + 2 * home + 1);
    const float ncx = __ldg(center + 2 * src), ncy = __ldg(center + 2 * src + 1), nd = __ldg(state_d + src);
    const float nx = __ldg(state_n + 3 * src), ny = __ldg(state_n + 3 * src + 1), nz = __ldg(state_n + 3 * src + 2);
    const float num = __fadd_rn(__fadd_rn(__fmul_rn(nx, __fsub_rn(ncx, cx)), __fmul_rn(ny, __fsub_rn(ncy, cy))),
                                __fmul_rn(nz, nd));
    const float cdiff = __fadd_rn(__fadd_rn(sq(__fsub_rn(__ldg(color + 3 * home), __ldg(color + 3 * src))),
                                            sq(__fsub_rn(__ldg(color + 3 * home + 1), __ldg(color + 3 * src + 1)))),
                                  sq(__fsub_rn(__ldg(color + 3 * home + 2), __ldg(color + 3 * src + 2))));
    d_c[i] = __fdiv_rn(num, nz);
    n_c[3 * i] = nx;
    n_c[3 * i + 1] = ny;
    n_c[3 * i + 2] = nz;
    sim[i] = ftz(expf(__fmul_rn(-cdiff, gamma)));
    ok[i] = (unsigned)tx < (unsigned)Mw && (unsigned)ty < (unsigned)Mh;
  }
}

// An asynchronous 4-byte copy from global to shared memory (cp.async).
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// A cell's 8 ring entries of one field into registers: two 16-byte loads
// (the warp's first covers every sector of the tile's 1 KB, its second hits
// them in L1), or eight 4-byte ones where the field's base is not 16-byte
// aligned.
__device__ __forceinline__ void ring8(float (&v)[kRing], const float* __restrict__ src, bool vec) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src)), b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int r = 0; r < kRing; ++r) v[r] = __ldg(src + r);
  }
}

__global__ void __launch_bounds__(kUpdateThreads) chain_update_kernel(
    const float* __restrict__ d_c, const float* __restrict__ n_c,  // (M, N), (M, N, 3)
    const float* __restrict__ sim, const unsigned char* __restrict__ ok,
    const float* __restrict__ sm1, const float* __restrict__ cs1,  // (M, N) each
    const float* __restrict__ d_in, const float* __restrict__ sm_in, const float* __restrict__ cs_in,
    const float* __restrict__ n_in,                                // (N,) x 3, (N, 3)
    const float* __restrict__ ring_dcx, const float* __restrict__ ring_dcy, const float* __restrict__ ring_d,
    const unsigned char* __restrict__ ring_ok,                     // (N, 8) each
    float* __restrict__ d_out, float* __restrict__ sm_out, float* __restrict__ cs_out,
    float* __restrict__ n_out,                                     // (N,) x 3, (N, 3)
    float* __restrict__ n_ref, unsigned char* __restrict__ ok_ref, // (8, N, 3), (8, N)
    int M, int N, int greedy) {
  // each warp's own: a chunk's scores, lane = cell, and 32 normals on their way out
  __shared__ float s_sm[kTileWarps][kChunk][kTile], s_cs[kTileWarps][kChunk][kTile];
  __shared__ float s_sim[kTileWarps][kChunk][kTile];
  __shared__ float s_out[kTileWarps][3 * kTile];

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c0 = (blockIdx.x * kTileWarps + w) * kTile;
  if (c0 >= N) return;  // no barrier below: each warp walks its own tile
  const int n = min(kTile, N - c0), c = c0 + lane;
  const bool live = lane < n;

  const bool vec = ((reinterpret_cast<size_t>(ring_dcx) | reinterpret_cast<size_t>(ring_dcy) |
                     reinterpret_cast<size_t>(ring_d)) & 15) == 0;
  float dcx[kRing], dcy[kRing], rd[kRing];
  unsigned rok = 0;  // ring_ok[r] in bit r
  float sm0 = 0.0f, cs0 = 0.0f;
  if (live) {
    ring8(dcx, ring_dcx + kRing * c, vec);
    ring8(dcy, ring_dcy + kRing * c, vec);
    ring8(rd, ring_d + kRing * c, vec);
    if ((reinterpret_cast<size_t>(ring_ok) & 7) == 0) {  // the cell's 8 flags in one load
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(ring_ok + kRing * c));
#pragma unroll
      for (int r = 0; r < kRing / 2; ++r)
        rok |= ((q.x >> 8 * r & 0xff) != 0) << r | ((q.y >> 8 * r & 0xff) != 0) << (r + 4);
    } else {
#pragma unroll
      for (int r = 0; r < kRing; ++r) rok |= (__ldg(ring_ok + kRing * c + r) != 0) << r;
    }
    sm0 = __ldg(sm_in + c);
    cs0 = __ldg(cs_in + c);
  }

  int best = -1;  // the last accepted move
  for (int kb = 0; kb < M; kb += kChunk) {
    const int mc = min(kChunk, M - kb);
    __syncwarp();  // the last chunk's walk is done with its scores
    unsigned okm = 0;  // ok of the chunk's move j in bit j
    if (live) {
      for (int j = 0; j < mc; ++j) {
        const int i = (kb + j) * N + c;
        cp_async4(&s_sm[w][j][lane], sm1 + i);
        cp_async4(&s_cs[w][j][lane], cs1 + i);
        if (greedy) cp_async4(&s_sim[w][j][lane], sim + i);
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < mc) okm |= (__ldg(ok + (kb + j) * N + c) != 0) << j;
    }
    cp_async_wait_all();
    if (live) {
      for (int j = 0; j < mc; ++j) {
        const float s1 = s_sm[w][j][lane], c1 = s_cs[w][j][lane];
        bool cond = ftz(__fmul_rn(c1, s1)) > ftz(__fmul_rn(sm0, cs0));
        if (greedy) cond = cond || ftz(__fmul_rn(s1, s_sim[w][j][lane])) > sm0;
        if ((okm >> j & 1) && cond) {
          sm0 = s1;
          cs0 = c1;
          best = kb + j;
        }
      }
    }
  }

  // d and n once: from the last accepted move, else from the input state
  float d0 = 0.0f;
  if (live) {
    const bool moved = best >= 0;
    const int i = moved ? best * N + c : c;
    const float* __restrict__ dsrc = moved ? d_c : d_in;
    const float* __restrict__ nsrc = moved ? n_c : n_in;
    d0 = __ldg(dsrc + i);
    s_out[w][3 * lane] = __ldg(nsrc + 3 * i);
    s_out[w][3 * lane + 1] = __ldg(nsrc + 3 * i + 1);
    s_out[w][3 * lane + 2] = __ldg(nsrc + 3 * i + 2);
    d_out[c] = d0;
    sm_out[c] = sm0;
    cs_out[c] = cs0;
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if (lane + 32 * q < 3 * n) n_out[3 * c0 + lane + 32 * q] = s_out[w][lane + 32 * q];

#pragma unroll
  for (int r = 0; r < kRing; ++r) {
    const int r2 = (r + 1) % kRing;
    __syncwarp();  // the last plane is out of s_out
    if (live) {
      const float v1x = dcx[r], v1y = dcy[r], v1z = __fsub_rn(rd[r], d0);
      const float v2x = dcx[r2], v2y = dcy[r2], v2z = __fsub_rn(rd[r2], d0);
      const float cx = __fsub_rn(__fmul_rn(v1y, v2z), __fmul_rn(v1z, v2y));
      const float cy = __fsub_rn(__fmul_rn(v2x, v1z), __fmul_rn(v1x, v2z));
      const float cz = __fsub_rn(__fmul_rn(v1x, v2y), __fmul_rn(v1y, v2x));
      const float norm = __fsqrt_rn(__fadd_rn(__fadd_rn(sq(cx), sq(cy)), sq(cz)));
      s_out[w][3 * lane] = __fdiv_rn(cx, norm);
      s_out[w][3 * lane + 1] = __fdiv_rn(cy, norm);
      s_out[w][3 * lane + 2] = __fdiv_rn(cz, norm);
      ok_ref[r * N + c] = (rok >> r & 1) && (rok >> r2 & 1);
    }
    __syncwarp();
    float* __restrict__ plane = n_ref + 3 * (r * N + c0);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (lane + 32 * q < 3 * n) plane[lane + 32 * q] = s_out[w][lane + 32 * q];
  }
}

__global__ void __launch_bounds__(kThreads) chain_refit_kernel(
    const float* __restrict__ n_ref, const unsigned char* __restrict__ ok_ref,  // (8, N, 3), (8, N)
    const float* __restrict__ sm1, const float* __restrict__ cs1,              // (8, N) each
    const float* __restrict__ sm_in, const float* __restrict__ cs_in, const float* __restrict__ n_in,
    float* __restrict__ sm_out, float* __restrict__ cs_out, float* __restrict__ n_out,
    int N, int greedy) {
  const int stride = gridDim.x * kThreads;
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < N; c += stride) {
    float sm0 = __ldg(sm_in + c), cs0 = __ldg(cs_in + c);
    float n0x = __ldg(n_in + 3 * c), n0y = __ldg(n_in + 3 * c + 1), n0z = __ldg(n_in + 3 * c + 2);
    for (int r = 0; r < kRing; ++r) {
      const int o = r * N + c;
      const float s1 = __ldg(sm1 + o), c1 = __ldg(cs1 + o);
      bool cond = ftz(__fmul_rn(s1, c1)) > ftz(__fmul_rn(sm0, cs0));
      if (greedy) cond = cond || s1 > sm0;
      if (__ldg(ok_ref + o) && cond) {
        sm0 = s1;
        cs0 = c1;
        n0x = __ldg(n_ref + 3 * o);
        n0y = __ldg(n_ref + 3 * o + 1);
        n0z = __ldg(n_ref + 3 * o + 2);
      }
    }
    sm_out[c] = sm0;
    cs_out[c] = cs0;
    n_out[3 * c] = n0x;
    n_out[3 * c + 1] = n0y;
    n_out[3 * c + 2] = n0z;
  }
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on ``stream`` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments it cannot take; neither synchronises.

// The candidates of the M update moves at offsets `offs` (M x (dx, dy),
// int32, on the card) for the cells of the rows row0 .. row0 + rows - 1 of
// V maps of Mh x Mw cells.
extern "C" int chain_moves_launch(const float* center, const float* color, const float* state_d,
                                  const float* state_n, const int* offs, float* d_c, float* n_c, float* sim,
                                  unsigned char* ok, int M, int V, int Mh, int Mw, int row0, int rows, float gamma,
                                  void* stream) {
  if (M < 0 || V < 0 || Mh < 0 || Mw < 0 || row0 < 0 || rows < 0 || row0 + rows > Mh ||
      3LL * V * Mh * Mw > 0x7fffffffLL || 3LL * M * V * rows * Mw > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)M * V * rows * Mw;
  if (total == 0) return 0;
  chain_moves_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      center, color, state_d, state_n, offs, d_c, n_c, sim, ok, M, V, Mh, Mw, row0, rows, gamma);
  return (int)cudaGetLastError();
}

// The state of N cells after their M update moves, and their 8 refit
// normals; `greedy` nonzero for the sweeps it < 4.
extern "C" int chain_update_launch(const float* d_c, const float* n_c, const float* sim, const unsigned char* ok,
                                   const float* sm1, const float* cs1, const float* d_in, const float* sm_in,
                                   const float* cs_in, const float* n_in, const float* ring_dcx,
                                   const float* ring_dcy, const float* ring_d, const unsigned char* ring_ok,
                                   float* d_out, float* sm_out, float* cs_out, float* n_out, float* n_ref,
                                   unsigned char* ok_ref, int M, int N, int greedy, void* stream) {
  if (M < 0 || N < 0 || 3LL * M * N > 0x7fffffffLL || 3LL * kRing * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int blocks = (int)(((long long)N + kTile * kTileWarps - 1) / (kTile * kTileWarps));
  chain_update_kernel<<<blocks, kUpdateThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d_c, n_c, sim, ok, sm1, cs1, d_in, sm_in, cs_in, n_in, ring_dcx, ring_dcy, ring_d, ring_ok, d_out, sm_out,
      cs_out, n_out, n_ref, ok_ref, M, N, greedy);
  return (int)cudaGetLastError();
}

// The state of N cells after their 8 refits.
extern "C" int chain_refit_launch(const float* n_ref, const unsigned char* ok_ref, const float* sm1,
                                  const float* cs1, const float* sm_in, const float* cs_in, const float* n_in,
                                  float* sm_out, float* cs_out, float* n_out, int N, int greedy, void* stream) {
  if (N < 0 || 3LL * kRing * N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  chain_refit_kernel<<<blocks_for(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_ref, ok_ref, sm1, cs1, sm_in, cs_in, n_in, sm_out, cs_out, n_out, N, greedy);
  return (int)cudaGetLastError();
}
