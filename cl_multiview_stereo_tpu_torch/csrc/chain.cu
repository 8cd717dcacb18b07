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
// chain_update: one thread a cell.  With the scores (sm1, cs1) of the M
//   update moves, in move order: accept = ok && (ftz(cs1 * sm1) >
//   ftz(sm0 * cs0) || greedy && ftz(sm1 * sim) > sm0); an accepted move
//   replaces d, sm, cs and n.  It writes that state, then the 8 ring refit
//   normals of the new d (_RING's order, r2 = (r + 1) % 8):
//     v1 = (dcx[r], dcy[r], ring_d[r] - d), v2 the same at r2,
//     c  = refine._cross(v1, v2), |c| = sqrt((cx*cx + cy*cy) + cz*cz),
//     n_ref[r] = (cx / |c|, cy / |c|, cz / |c|), ok_ref[r] = ok[r] && ok[r2].
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
// Layout: each thread reads and writes its own (move,) cell's entries, so
// consecutive threads touch consecutive cells; the cell maps (7 MB a field
// set at 9 x 135 x 240) stay in L2 for the neighbour reads.

#include <cuda_runtime.h>

namespace {

constexpr float kFltMin = 1.17549435e-38f;  // smallest normal float32
constexpr int kRing = 8;
constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads) chain_update_kernel(
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
  const int stride = gridDim.x * kThreads;
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < N; c += stride) {
    float d0 = __ldg(d_in + c), sm0 = __ldg(sm_in + c), cs0 = __ldg(cs_in + c);
    float n0x = __ldg(n_in + 3 * c), n0y = __ldg(n_in + 3 * c + 1), n0z = __ldg(n_in + 3 * c + 2);
    for (int k = 0; k < M; ++k) {
      const int o = k * N + c;
      const float s1 = __ldg(sm1 + o), c1 = __ldg(cs1 + o);
      bool cond = ftz(__fmul_rn(c1, s1)) > ftz(__fmul_rn(sm0, cs0));
      if (greedy) cond = cond || ftz(__fmul_rn(s1, __ldg(sim + o))) > sm0;
      if (__ldg(ok + o) && cond) {
        d0 = __ldg(d_c + o);
        sm0 = s1;
        cs0 = c1;
        n0x = __ldg(n_c + 3 * o);
        n0y = __ldg(n_c + 3 * o + 1);
        n0z = __ldg(n_c + 3 * o + 2);
      }
    }
    d_out[c] = d0;
    sm_out[c] = sm0;
    cs_out[c] = cs0;
    n_out[3 * c] = n0x;
    n_out[3 * c + 1] = n0y;
    n_out[3 * c + 2] = n0z;
    for (int r = 0; r < kRing; ++r) {
      const int r2 = (r + 1) % kRing;
      const float v1x = __ldg(ring_dcx + kRing * c + r), v1y = __ldg(ring_dcy + kRing * c + r);
      const float v1z = __fsub_rn(__ldg(ring_d + kRing * c + r), d0);
      const float v2x = __ldg(ring_dcx + kRing * c + r2), v2y = __ldg(ring_dcy + kRing * c + r2);
      const float v2z = __fsub_rn(__ldg(ring_d + kRing * c + r2), d0);
      const float cx = __fsub_rn(__fmul_rn(v1y, v2z), __fmul_rn(v1z, v2y));
      const float cy = __fsub_rn(__fmul_rn(v2x, v1z), __fmul_rn(v1x, v2z));
      const float cz = __fsub_rn(__fmul_rn(v1x, v2y), __fmul_rn(v1y, v2x));
      const float norm = __fsqrt_rn(__fadd_rn(__fadd_rn(sq(cx), sq(cy)), sq(cz)));
      const int o = r * N + c;
      n_ref[3 * o] = __fdiv_rn(cx, norm);
      n_ref[3 * o + 1] = __fdiv_rn(cy, norm);
      n_ref[3 * o + 2] = __fdiv_rn(cz, norm);
      ok_ref[o] = __ldg(ring_ok + kRing * c + r) && __ldg(ring_ok + kRing * c + r2);
    }
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
  chain_update_kernel<<<blocks_for(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
