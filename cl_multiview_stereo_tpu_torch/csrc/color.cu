// RGB -> CIELab (cvt / rgb2lab, clcode.cl:21-59 and :125-151) for Hopper
// (sm_90a): a persistent grid walks tiles of 1,024 pixels, each staged
// through shared memory.
//
// Replaces the JAX package's rgb_to_lab (cl_multiview_stereo_tpu/ops/
// color.py:46), an XLA function, not Pallas.  The port's plain form
// (ops/color.rgb_to_lab_reference) runs about 48 elementwise passes over
// the image, each reading and writing a float32 plane: at 9 x 1080 x 1920
// about 3.6 GB of traffic for a function that needs 3 bytes in and 12
// bytes out a pixel.
//
// The arithmetic (to_lab) is held bitwise to the plain form run on the
// card, so it repeats the op sequence torch executes there, one rounding
// an op, in the plain form's order:
//   - every constant is a Python double rounded to float32, as torch
//     rounds a scalar operand (static_cast<float> of the double literal,
//     not the float literal, which could round the decimal differently);
//   - X = (r m00 + g m01) + b m02, each product rounded;
//   - a tensor divided by a Python scalar on the card is a product with
//     the scalar's reciprocal, taken in double and rounded to float32, so
//     X / 0.950456, Z / 1.088754 and / 116 are __fmul_rn by
//     static_cast<float>(1.0 / c) (and Y / 1.0 is Y).  The float
//     reciprocal of the float constant is one ulp off it for 1.088754,
//     and then 4,858,640 of the 2^24 uint8 triples' b differ; the IEEE
//     divide the CPU's plain form runs differs too;
//   - torch.pow(t, 1/3) on the card is powf(t, 0.33333334f), not cbrtf;
//   - the where() of f() takes one branch; the plain form computes both
//     and selects, with the same values.
// --fmad=false and the _rn intrinsics keep nvcc from contracting any of
// these into an FMA.
//
// Bound: the bytes (15 a pixel, 0.084 ms at 9 x 1080 x 1920 over 3.35
// TB/s), then the issue of about 3 powf a pixel.  A first form, one thread
// a pixel straight from global memory, read 1 byte and wrote 4 at a
// 3-element lane stride: each warp store touched the same 12 sectors three
// times.  Here every byte moves between L2 and the SM once, in whole
// 16-byte pieces:
//   - lab_kernel: each block takes tiles t = blockIdx.x, + gridDim.x, ...
//     (the grid is what fits on the card at once).  A tile's input (3,072
//     bytes of uint8, 12,288 of float32) lands in one of two shared
//     buffers by one cp.async.bulk (the 1-D TMA copy, completing on the
//     buffer's mbarrier), two tiles in flight, so the next tile's load
//     runs under this tile's arithmetic (16-byte cp.async copies of every
//     lane took the same time: PERF.md);
//   - each thread converts pixels p, p + 256, ... of the tile out of shared
//     memory (a 3-element stride: no bank conflict) into one of two output
//     tiles in shared memory, which leaves as 16-byte stores of
//     neighbouring lanes on neighbouring addresses;
//   - a base that is not 16-byte aligned (a view's storage offset) and the
//     ragged last tile take the same arithmetic straight from global
//     memory, one pixel a thread, in the same kernel.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // pixels a tile
constexpr int kPerThread = kTile / kThreads;
constexpr int kOutBytes = 3 * kTile * 4;
// 16-byte stores of an output tile a thread
constexpr int kStores = kOutBytes / 16 / kThreads;
// the most pixels a launch takes: a thread's index plus the grid's stride
// stays inside an int
constexpr int kMaxPixels = 1 << 30;

// the plain form's constants, each a Python double rounded to float32
constexpr float kScale = static_cast<float>(0.0039216);
constexpr float kEpsilon = static_cast<float>(0.008856);
constexpr float kKappa = static_cast<float>(903.3);
// the white point's X and Z and the linear branch's 116, as the
// reciprocals the card multiplies by
constexpr float kInvWhiteX = static_cast<float>(1.0 / 0.950456);
constexpr float kInvWhiteZ = static_cast<float>(1.0 / 1.088754);
constexpr float kInv116 = static_cast<float>(1.0 / 116.0);
constexpr float kThird = static_cast<float>(1.0 / 3.0);
// the RGB -> XYZ matrix, row by row
constexpr float kM00 = static_cast<float>(0.412453), kM01 = static_cast<float>(0.357580),
                kM02 = static_cast<float>(0.180423);
constexpr float kM10 = static_cast<float>(0.212671), kM11 = static_cast<float>(0.715160),
                kM12 = static_cast<float>(0.072169);
constexpr float kM20 = static_cast<float>(0.019334), kM21 = static_cast<float>(0.119193),
                kM22 = static_cast<float>(0.950227);

// CIE f(): cube root above epsilon, linear below (the plain form's _f_cbrt)
__device__ __forceinline__ float f_cbrt(float t) {
  if (t > kEpsilon) return powf(t, kThird);
  return __fmul_rn(__fadd_rn(__fmul_rn(t, kKappa), 16.0f), kInv116);
}

// one row of the RGB -> XYZ matrix: (r m0 + g m1) + b m2
__device__ __forceinline__ float row(float r, float g, float b, float m0, float m1, float m2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r, m0), __fmul_rn(g, m1)), __fmul_rn(b, m2));
}

// Lab of the pixel at src[0..2] into dst[0..2]
template <typename T>
__device__ __forceinline__ void to_lab(const T* src, float* dst) {
  const float r = __fmul_rn(static_cast<float>(src[0]), kScale);
  const float g = __fmul_rn(static_cast<float>(src[1]), kScale);
  const float b = __fmul_rn(static_cast<float>(src[2]), kScale);
  const float fx = f_cbrt(__fmul_rn(row(r, g, b, kM00, kM01, kM02), kInvWhiteX));
  const float fy = f_cbrt(row(r, g, b, kM10, kM11, kM12));
  const float fz = f_cbrt(__fmul_rn(row(r, g, b, kM20, kM21, kM22), kInvWhiteZ));
  dst[0] = __fsub_rn(__fmul_rn(fy, 116.0f), 16.0f);
  dst[1] = __fmul_rn(__fsub_rn(fx, fy), 500.0f);
  dst[2] = __fmul_rn(__fsub_rn(fy, fz), 200.0f);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One tile's input, `bytes` from global `src` into shared `dst` (both
// 16-byte aligned, `bytes` a multiple of 16): one bulk copy, issued by
// thread 0, completing on `bar`.
__device__ __forceinline__ void load_tile(void* dst, const void* src, int bytes, uint64_t* bar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
  }
}

// Waits until the tile loaded into a buffer has landed: the `phase`-th
// completion of its `bar`.
__device__ __forceinline__ void wait_tile(uint64_t* bar, unsigned phase) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
}

template <typename T>
__host__ __device__ constexpr int in_bytes() { return 3 * kTile * (int)sizeof(T); }

// dynamic shared memory of lab_kernel<T>: two input tiles, two output
// tiles, two mbarriers
template <typename T>
__host__ __device__ constexpr int smem_bytes() { return 2 * in_bytes<T>() + 2 * kOutBytes + 16; }

template <typename T>
__global__ void __launch_bounds__(kThreads) lab_kernel(const T* __restrict__ rgb, float* __restrict__ out, int n,
                                                       int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* in = reinterpret_cast<T*>(smem);
  float* obuf = reinterpret_cast<float*>(smem + 2 * in_bytes<T>());
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * in_bytes<T>() + 2 * kOutBytes);
  const int first = blockIdx.x, stride = gridDim.x;
  if (first < tiles) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < 2; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar + s)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    for (int s = 0; s < 2; ++s) {
      const int t = first + s * stride;
      if (t < tiles) load_tile(in + s * 3 * kTile, rgb + (long long)t * 3 * kTile, in_bytes<T>(), bar + s);
    }
    int k = 0;
    for (int t = first; t < tiles; t += stride, ++k) {
      const int s = k & 1;
      wait_tile(bar + s, (k >> 1) & 1);
      const T* src = in + s * 3 * kTile;
      float* dst = obuf + s * 3 * kTile;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int p = threadIdx.x + j * kThreads;
        to_lab(src + 3 * p, dst + 3 * p);
      }
      // every lane is done with input buffer s and has written output tile
      // s; output tile s was last stored two tiles ago, before the
      // previous tile's barrier
      __syncthreads();
      const int next = t + 2 * stride;
      if (next < tiles) load_tile(in + s * 3 * kTile, rgb + (long long)next * 3 * kTile, in_bytes<T>(), bar + s);
      float4* g = reinterpret_cast<float4*>(out + (long long)t * 3 * kTile);
      const float4* d = reinterpret_cast<const float4*>(dst);
#pragma unroll
      for (int j = 0; j < kStores; ++j) g[threadIdx.x + j * kThreads] = d[threadIdx.x + j * kThreads];
    }
  }
  // the pixels after the last whole tile (all of them when the grid was
  // launched without tiles), one a thread
  const int step = stride * kThreads;
  for (int p = tiles * kTile + first * kThreads + threadIdx.x; p < n; p += step) {
    const long long q = 3LL * p;
    to_lab(rgb + q, out + q);
  }
}

template <typename T>
cudaError_t configure() {
  return cudaFuncSetAttribute(lab_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
}

// blocks of lab_kernel<T> resident on one SM
template <typename T>
cudaError_t blocks_per_sm(int* blocks) {
  const cudaError_t e = configure<T>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lab_kernel<T>, kThreads, smem_bytes<T>());
}

template <typename T>
int launch(const T* rgb, float* out, int n, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = blocks_per_sm<T>(&per_sm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // whole tiles only when both bases take 16-byte copies
  const bool aligned = ((reinterpret_cast<uintptr_t>(rgb) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int tiles = aligned ? n / kTile : 0;
  const long long want = tiles > 0 ? tiles : (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (long long)sms * per_sm ? want : (long long)sms * per_sm);
  lab_kernel<T><<<blocks, kThreads, smem_bytes<T>(), stream>>>(rgb, out, n, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the kernel for uint8 (is_float 0) or float32 (1) input that
// fit on one SM at once, into ``*blocks``; returns the CUDA error (0 on
// success).  A launch's grid is this times the SM count, or fewer.
extern "C" int lab_convert_blocks_per_sm(int is_float, int* blocks) {
  return (int)(is_float ? blocks_per_sm<float>(blocks) : blocks_per_sm<uint8_t>(blocks));
}

// Plain C entry point, bound with ctypes.  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments it cannot take; it does not synchronise.
//
// Lab of `n` pixels of 3 channels: `rgb` uint8 (is_float 0) or float32
// (is_float 1), `out` float32.
extern "C" int lab_convert_launch(const void* rgb, float* out, int n, int is_float, void* stream) {
  if (n < 0 || n > kMaxPixels || (is_float != 0 && is_float != 1)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) return launch(static_cast<const float*>(rgb), out, n, s);
  return launch(static_cast<const uint8_t*>(rgb), out, n, s);
}
